"""Lie-group layer: functional cores over ``(..., n, n)`` torch tensors.

Ported so far: ``so2``, ``se2``, ``so3``, ``se3`` and ``sim3``.  The object
wrappers of ``pyslam_tpu.lie`` come with a later slice of the port.
"""

from . import se2, se3, sim3, so2, so3

__all__ = ["so2", "se2", "so3", "se3", "sim3"]
