"""Fused RMSNorm over rows."""
