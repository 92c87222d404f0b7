"""The dualquant op (see ops.py)."""
