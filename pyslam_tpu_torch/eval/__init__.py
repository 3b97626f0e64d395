"""Trajectory evaluation and visualization (the reference's ``eval``)."""

from .metrics import TrajectoryMetrics
from .sync import associate, interpolate_poses
from .viz import TrajectoryVisualizer

__all__ = [
    "TrajectoryMetrics",
    "TrajectoryVisualizer",
    "associate",
    "interpolate_poses",
]
