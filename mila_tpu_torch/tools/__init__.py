"""Measurement tools for the port, run on a GPU."""
