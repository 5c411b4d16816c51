"""NN models (SuperPoint, DISK), their packaged weights, and synthetic data."""
