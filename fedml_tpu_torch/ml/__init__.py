"""Training and aggregation engine of the PyTorch port."""
