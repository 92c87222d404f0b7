"""Fixed-width compressed collectives (port of repro.io.collectives)."""
from . import collectives  # noqa: F401
