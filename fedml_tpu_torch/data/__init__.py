"""Data layer of the PyTorch port: loaders, partitions, synthetic stand-ins."""
