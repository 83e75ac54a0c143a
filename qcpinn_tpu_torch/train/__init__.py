"""Training pieces of the PyTorch port."""
