"""Training (the JAX package's `train/`)."""
