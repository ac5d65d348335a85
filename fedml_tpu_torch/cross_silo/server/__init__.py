"""The server side of the cross-silo plane."""
