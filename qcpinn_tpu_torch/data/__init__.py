"""Problem data of the PyTorch port."""
