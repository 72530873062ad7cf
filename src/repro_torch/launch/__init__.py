"""Launchers: the one-device LM training step (the mesh waits)."""
