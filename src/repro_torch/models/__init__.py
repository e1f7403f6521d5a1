"""Model stack of the PyTorch port (dense attention subset)."""
