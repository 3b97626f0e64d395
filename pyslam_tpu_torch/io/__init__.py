"""Dataset I/O.  Ported so far: the synthetic generators, the g2o
reader/writer and the BAL reader/writer (numpy only)."""

from . import bal, g2o, synth  # noqa: F401
