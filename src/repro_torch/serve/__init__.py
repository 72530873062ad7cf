"""Offload inference runtime and the weak-device cost model."""
