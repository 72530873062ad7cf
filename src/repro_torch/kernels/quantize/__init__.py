"""Nearest-center quantizer."""
