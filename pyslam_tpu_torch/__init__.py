"""pyslam_tpu_torch — the PyTorch + CUDA port of ``pyslam_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``pyslam_tpu`` is the reference; this package mirrors its
module paths and function names, imports neither JAX nor ``pyslam_tpu``,
and replaces each of its Pallas TPU kernels with a CUDA kernel written by
hand (``csrc/``, built by ``_ext`` at first use).

Ported so far (the pose-graph solves of sphere2500 and of bench configs
1, 2 and 7):

  * ``lie``     — SO(2) / SE(2) / SO(3) / SE(3) / Sim(3) functional cores
  * ``losses``  — robust M-estimators for IRLS
  * ``graph``   — factor graph core, the SE(2) / SE(3) / Sim(3) prior and
                  between factors, ``build.pose_graph`` /
                  ``build.sim3_pose_graph``, ``convert.graph_from_numpy``
  * ``io``      — synthetic dataset generators, g2o reader/writer
  * ``solver``  — GN / LM / dogleg over dense assembly and Cholesky
                  (``solve``, ``solve_one_iter``) or direct-to-ELL assembly
                  and PCG (``solve_ell``), and the ``ell_matvec`` /
                  ``ell_pcg`` / ``slot_reduce`` CUDA kernels

Entry points that build tensors (``build.pose_graph``,
``build.sim3_pose_graph``, ``convert.graph_from_numpy``, the Lie modules'
``identity``) put them on ``default_device()``, the CUDA card, unless the
caller names a device; ``device="cpu"`` asks for the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

# A nonlinear least-squares solver needs full-f32 products: TF32 keeps about
# three decimal digits.  Counterpart of the reference's
# jax_default_matmul_precision = "highest".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from ._device import default_device  # noqa: E402,F401
from . import graph, imu, io, lie, losses, solver  # noqa: E402,F401
