"""Paged flash-decoding of one query token against a KV cache."""
