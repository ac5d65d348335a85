"""The user-overridable trainer and aggregator contracts."""
