"""Local update, model bundle, optimizers and device selection."""
