"""Dense direct VO frontends and frame-to-frame RANSAC (the reference's
``pipelines``)."""

from .dense import DenseRGBDPipeline, DenseStereoPipeline
from .keyframes import (
    DenseKeyframe,
    DenseRGBDKeyframe,
    DenseStereoKeyframe,
    compute_disparity,
)
from .photometric import PhotometricResidualSE3
from .ransac import FrameToFrameRANSAC

__all__ = [
    "FrameToFrameRANSAC",
    "DenseStereoPipeline",
    "DenseRGBDPipeline",
    "DenseKeyframe",
    "DenseStereoKeyframe",
    "DenseRGBDKeyframe",
    "PhotometricResidualSE3",
    "compute_disparity",
]
