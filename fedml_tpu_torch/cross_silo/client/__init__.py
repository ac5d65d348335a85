"""The silo side of the cross-silo plane."""
