"""Peaks of the card, least times of kernels, and FLOP counts from shapes."""
