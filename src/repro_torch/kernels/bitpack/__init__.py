"""The bitpack ops (see ops.py)."""
