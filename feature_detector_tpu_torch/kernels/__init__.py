"""Detection, greedy selection (hand CUDA kernel) and steered BRIEF."""
