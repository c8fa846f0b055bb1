"""Training steps of the PyTorch port."""
