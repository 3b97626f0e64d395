"""Dataset I/O: the synthetic generators, the g2o, BAL and EuRoC readers
and writers, and the TUM / KITTI trajectory files (numpy only)."""

from . import bal, euroc, g2o, synth, trajectory  # noqa: F401
