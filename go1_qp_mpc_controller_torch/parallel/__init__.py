"""Scenario sweeps of the PyTorch port (one GPU)."""
