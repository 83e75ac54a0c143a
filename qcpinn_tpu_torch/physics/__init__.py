"""PDE residuals of the PyTorch port."""
