"""Struct-of-arrays factor-graph core on torch tensors."""

from . import factor_defs  # noqa: F401  (registers factor kernels)
from .convert import graph_from_numpy
from .core import (
    FACTOR_KERNELS,
    MANIFOLDS,
    FactorBatch,
    FactorGraph,
    VariableBlock,
    manifold_dof,
    register_factor,
    retract,
)

__all__ = [
    "FactorBatch",
    "FactorGraph",
    "VariableBlock",
    "MANIFOLDS",
    "FACTOR_KERNELS",
    "manifold_dof",
    "register_factor",
    "retract",
    "graph_from_numpy",
]
