"""Model code of the PyTorch port (dense decoder family, decode side)."""
