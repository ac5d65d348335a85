"""Core of the PyTorch port: the trainer and aggregator contracts and the message plane."""
