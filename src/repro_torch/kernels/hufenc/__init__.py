"""The hufenc op (see ops.py)."""
