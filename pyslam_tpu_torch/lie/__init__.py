"""Lie-group layer.

Functional cores over ``(..., n, n)`` torch tensors, broadcast-batched:
``so2``, ``se2``, ``so3``, ``se3`` and ``sim3``.

Object wrappers (the reference's ``liegroups``-style API, and ``Sim3``):
``SO2``, ``SE2``, ``SO3``, ``SE3``, ``Sim3`` (``groups.py``).
"""

from . import se2, se3, sim3, so2, so3
from .groups import SE2, SE3, SO2, SO3, Sim3

__all__ = ["so2", "se2", "so3", "se3", "sim3", "SO2", "SE2", "SO3", "SE3", "Sim3"]
