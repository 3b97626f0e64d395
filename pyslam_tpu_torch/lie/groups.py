"""Object API over the functional Lie cores.

Counterpart of ``pyslam_tpu/lie/groups.py``: the ``liegroups``-style
classes ``SO2``, ``SO3``, ``SE2``, ``SE3`` and ``Sim3``, thin wrappers
around a ``(..., n, n)`` tensor ``mat``, so that user code written against
``SE3.exp(xi)``, ``T.dot(other)``, ``T.inv()``, ``T.adjoint()`` or
``T.perturb(xi)`` carries over.  The solver paths use the functional
modules directly.

A wrapper keeps the tensor it is given where it is: numpy input becomes a
CPU tensor, a CUDA tensor stays on its card.  ``identity`` builds on
``default_device()``, the CUDA card, unless a device is named.
"""

from __future__ import annotations

import torch

from . import se2, se3, sim3, so2, so3


class _LieGroupBase:
    """Shared wrapper machinery; subclasses bind ``_ops`` / ``dim`` / ``dof``."""

    _ops = None
    dim = None
    dof = None

    def __init__(self, mat):
        mat = getattr(mat, "mat", mat)
        self.mat = torch.as_tensor(mat)

    # --- constructors -----------------------------------------------------
    @classmethod
    def exp(cls, xi):
        return cls(cls._ops.exp(torch.as_tensor(xi)))

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32, device=None):
        return cls(cls._ops.identity(dtype=dtype, batch_shape=batch_shape, device=device))

    @classmethod
    def from_matrix(cls, mat, normalize: bool = False):
        out = cls(mat)
        return out.normalize() if normalize else out

    @classmethod
    def wedge(cls, xi):
        return cls._ops.wedge(torch.as_tensor(xi))

    @classmethod
    def vee(cls, Xi):
        return cls._ops.vee(torch.as_tensor(Xi))

    @classmethod
    def left_jacobian(cls, xi):
        return cls._ops.left_jacobian(torch.as_tensor(xi))

    @classmethod
    def inv_left_jacobian(cls, xi):
        return cls._ops.inv_left_jacobian(torch.as_tensor(xi))

    # --- group ops ---------------------------------------------------------
    def log(self):
        return self._ops.log(self.mat)

    def inv(self):
        return type(self)(self._ops.inv(self.mat))

    def dot(self, other):
        if isinstance(other, _LieGroupBase):
            return type(self)(self.mat @ other.mat)
        # act on points: (..., d) or (N, d)
        return self._ops.act(self.mat, torch.as_tensor(other))

    def __mul__(self, other):
        return self.dot(other)

    def perturb(self, xi):
        return type(self)(self._ops.perturb(self.mat, torch.as_tensor(xi)))

    def as_matrix(self):
        return self.mat

    def normalize(self):
        if hasattr(self._ops, "normalize"):
            return type(self)(self._ops.normalize(self.mat))
        return self

    def __repr__(self):
        return f"{type(self).__name__}({self.mat})"


class SO2(_LieGroupBase):
    _ops = so2
    dim = 2
    dof = 1


class SO3(_LieGroupBase):
    _ops = so3
    dim = 3
    dof = 3


class _RigidBase(_LieGroupBase):
    def adjoint(self):
        return self._ops.adjoint(self.mat)

    @classmethod
    def odot(cls, p, **kw):
        return cls._ops.odot(torch.as_tensor(p), **kw)

    @property
    def rot(self):
        d = self.dim - 1
        rot_cls = SO2 if d == 2 else SO3
        return rot_cls(self.mat[..., :d, :d])

    @property
    def trans(self):
        d = self.dim - 1
        return self.mat[..., :d, d]


class SE2(_RigidBase):
    _ops = se2
    dim = 3
    dof = 3


class SE3(_RigidBase):
    _ops = se3
    dim = 4
    dof = 6


class Sim3(_LieGroupBase):
    """Similarity transforms [[s*R, t], [0, 1]] (``lie/sim3.py``)."""

    _ops = sim3
    dim = 4
    dof = 7

    def adjoint(self):
        return self._ops.adjoint(self.mat)

    @property
    def rot(self):
        return SO3(self._ops.rot(self.mat))

    @property
    def trans(self):
        return self.mat[..., :3, 3]

    @property
    def scale(self):
        return self._ops.scale(self.mat)
