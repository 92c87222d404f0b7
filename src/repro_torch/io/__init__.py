"""Parallel I/O of the port: the ``.ceazs`` stream engine, the
compressed file write and the fixed-width compressed collectives (ports
of the reference's ``io/engine.py``, ``io/filewrite.py`` and
``io/collectives.py``)."""
from . import collectives, engine, filewrite  # noqa: F401
