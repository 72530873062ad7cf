"""Quantization and payload coding of offloaded features."""
