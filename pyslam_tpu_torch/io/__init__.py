"""Dataset I/O.  Ported so far: the synthetic generators (numpy only)."""

from . import synth  # noqa: F401
