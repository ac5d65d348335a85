"""Simulation backends of the PyTorch port."""
