"""DSA decode block of the PyTorch port: indexer → Top-K → sparse attention."""
