"""Serving: int8 weight quantization of the functional LM's parameters."""
