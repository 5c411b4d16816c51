"""Options, containers, device resolution and conversion from the JAX package."""
