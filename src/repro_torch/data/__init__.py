"""Synthetic datasets of the port (numpy)."""
