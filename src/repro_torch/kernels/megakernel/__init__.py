"""The megakernel op (see ops.py)."""
