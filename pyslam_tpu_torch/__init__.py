"""pyslam_tpu_torch — the PyTorch + CUDA port of ``pyslam_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``pyslam_tpu`` is the reference; this package mirrors its
module paths and function names, imports neither JAX nor ``pyslam_tpu``,
and replaces each of its Pallas TPU kernels with a CUDA kernel written by
hand (``csrc/``, built by ``_ext`` at first use).

Not ported yet: the component-major sharded Schur path
(``dist/schur_cm.py``) and a few solver options (ROADMAP.md lists them).
Ported:

  * ``lie``       — SO(2) / SE(2) / SO(3) / SE(3) / Sim(3) functional cores
                    and the object wrappers ``SO2`` ... ``Sim3``
  * ``utils``     — invsqrt / stackmul / bilinear_interpolate / kahan_sum
  * ``sensors``   — StereoCamera / RGBDCamera with analytic Jacobians
  * ``losses``    — robust M-estimators for IRLS
  * ``residuals`` — the residual library over the batched factor kernels
  * ``problem``   — the Ceres-style ``Options`` / ``Problem`` API
  * ``graph``     — struct-of-arrays factor batches, the factor kernels
                    (analytic, autodiff and closed), builders,
                    initialization, marginalization
  * ``solver``    — GN / LM / dogleg over the dense, ELL-PCG, sparse
                    Cholesky and Schur paths, ``solve_auto``, covariance,
                    the smoothers, ``solve_implicit``, and the CUDA kernels
                    ``ell_matvec`` / ``ell_pcg`` / ``slot_reduce`` /
                    ``ell_assemble``
  * ``dist``      — the multi-device solves on ``torch.distributed``
  * ``imu``, ``io`` — preintegration; g2o / BAL / EuRoC readers, synthetic
                    data
  * ``debug``, ``observability`` — graph lint, NaN checks, solve logs,
                    profiling, checkpoints
  * ``pipelines`` — dense RGB-D and stereo direct VO (``track``,
                    ``prefetch``, ``track_batch``), the on-device block
                    matcher, the photometric factors, frame-to-frame RANSAC
  * ``eval``      — ``TrajectoryMetrics``, ``associate``,
                    ``interpolate_poses``, ``TrajectoryVisualizer``

Entry points that build tensors (the builders of ``graph.build``,
``convert.graph_from_numpy``, ``Problem``, the Lie ``identity``
functions and methods, the keyframes and pipelines, ``FrameToFrameRANSAC``,
``TrajectoryMetrics``) put them on ``default_device()``, the CUDA card,
unless the caller names a device; ``device="cpu"`` asks for the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

# A nonlinear least-squares solver needs full-f32 products: TF32 keeps about
# three decimal digits.  Counterpart of the reference's
# jax_default_matmul_precision = "highest".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from ._device import default_device  # noqa: E402,F401
from . import graph, imu, io, lie, losses, residuals, sensors, solver, utils  # noqa: E402,F401
from .lie import SE2, SE3, SO2, SO3, Sim3  # noqa: E402,F401
from .problem import Options, Problem  # noqa: E402,F401
from .residuals import (  # noqa: E402,F401
    BearingRangeResidual,
    DensePriorResidual,
    ImuResidual,
    LandmarkXYResidual,
    PoseResidual,
    PoseToPoseResidual,
    PoseToPoseSwitchableResidual,
    QuadraticResidual,
    ReprojectionMotionOnlyBatchResidual,
    ReprojectionResidual,
)
from .losses import (  # noqa: E402,F401
    CauchyLoss,
    HuberLoss,
    L1Loss,
    L2Loss,
    TDistributionLoss,
    TukeyLoss,
)
from .sensors import RGBDCamera, StereoCamera  # noqa: E402,F401
from . import debug, eval, observability, pipelines  # noqa: E402,F401
from .eval import TrajectoryMetrics, TrajectoryVisualizer  # noqa: E402,F401
