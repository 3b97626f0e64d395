"""Lie-group layer: functional cores over ``(..., n, n)`` torch tensors.

Ported so far: ``so3`` and ``se3``.  ``so2``, ``se2``, ``sim3`` and the
object wrappers of ``pyslam_tpu.lie`` come with later slices of the port.
"""

from . import se3, so3

__all__ = ["so3", "se3"]
