"""Checkpoints of parameter trees."""
