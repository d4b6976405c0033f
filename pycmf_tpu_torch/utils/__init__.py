"""Host-side utilities of the PyTorch port: validation, init, datasets,
conversion of fitted factors."""
