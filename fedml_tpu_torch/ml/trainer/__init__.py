"""Default client trainer and server aggregator."""
