"""Model code of the PyTorch port (dense and MoE decoder families, decode
side)."""
