"""Fused permute -> split -> nearest-center offload pass."""
