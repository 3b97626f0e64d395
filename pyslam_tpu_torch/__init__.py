"""pyslam_tpu_torch — the PyTorch + CUDA port of ``pyslam_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``pyslam_tpu`` is the reference; this package mirrors its
module paths and function names, imports neither JAX nor ``pyslam_tpu``,
and replaces each of its Pallas TPU kernels with a CUDA kernel written by
hand (``csrc/``, built by ``_ext`` at first use).

Ported so far (the sphere2500 pose-graph solve):

  * ``lie``     — SO(3) / SE(3) functional cores
  * ``losses``  — robust M-estimators for IRLS
  * ``graph``   — factor graph core, SE(3) factors, ``build.pose_graph``,
                  ``convert.graph_from_numpy``
  * ``io``      — synthetic dataset generators
  * ``solver``  — LM / GN, PCG, direct-to-ELL assembly, ``solve_ell``, and
                  the ``ell_matvec`` / ``slot_reduce`` CUDA kernels
"""

__version__ = "0.1.0"

import torch as _torch

# A nonlinear least-squares solver needs full-f32 products: TF32 keeps about
# three decimal digits.  Counterpart of the reference's
# jax_default_matmul_precision = "highest".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import graph, io, lie, losses, solver  # noqa: E402,F401
