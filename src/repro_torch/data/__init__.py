"""Synthetic data (numpy), as the JAX package makes it."""
