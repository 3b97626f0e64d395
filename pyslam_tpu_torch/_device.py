"""The device the package's entry points build on when the caller names
none: the CUDA card.  There is no fallback to the CPU; a caller that wants
the CPU (the CPU tests do) passes ``device="cpu"``."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``torch.device("cuda")``; raises where there is no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "pyslam_tpu_torch builds on the CUDA device by default and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to build on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; None means ``default_device()``."""
    return default_device() if device is None else torch.device(device)
