"""Cross-silo federated learning: a server and silos exchanging messages."""
