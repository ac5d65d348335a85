"""SP: the single-process sequential simulation."""
