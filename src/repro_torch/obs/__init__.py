"""Copies of the reference's telemetry layer (same metric and span names,
the same stream manifest schema)."""
