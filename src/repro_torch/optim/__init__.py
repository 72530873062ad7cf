"""Optimizers and schedules over parameter trees (dicts and lists of
tensors), as plain functions."""
