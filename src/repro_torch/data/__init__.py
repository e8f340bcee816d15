"""Synthetic data (the port of ``repro.data``)."""
