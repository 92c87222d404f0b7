"""Fused encode/decode pipelines of the port."""
