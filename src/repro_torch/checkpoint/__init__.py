"""Compressed, atomic, verified checkpoints of the port."""
from . import ckpt  # noqa: F401
