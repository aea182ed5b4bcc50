"""train layer of the PyTorch port."""
