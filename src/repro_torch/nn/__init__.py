"""Layers of the port: init, dense/conv, norms."""
