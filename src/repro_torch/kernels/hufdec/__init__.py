"""The hufdec op (see ops.py)."""
