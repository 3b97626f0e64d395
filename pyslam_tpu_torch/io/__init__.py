"""Dataset I/O.  Ported so far: the synthetic generators and the g2o
reader/writer (numpy only)."""

from . import g2o, synth  # noqa: F401
