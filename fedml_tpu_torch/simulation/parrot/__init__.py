"""Parrot: federated simulation on one device."""
