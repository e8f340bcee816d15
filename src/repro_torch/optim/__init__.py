"""Optimizers (the port of ``repro.optim``)."""
