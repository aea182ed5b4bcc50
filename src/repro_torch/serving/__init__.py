"""serving layer of the PyTorch port."""
