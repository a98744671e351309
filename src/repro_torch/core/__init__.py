"""Core selection algorithms of the PyTorch port: GVR, radix and exact
Top-K, and the temporal feedback helpers."""
