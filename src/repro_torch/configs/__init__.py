"""Model configs of the PyTorch port (copies of the JAX package's)."""
