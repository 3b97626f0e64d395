"""Struct-of-arrays factor-graph core on torch tensors."""

from . import factor_defs  # noqa: F401  (registers factor kernels)
from .convert import graph_from_numpy
from .core import (
    FACTOR_KERNELS,
    MANIFOLDS,
    FactorBatch,
    FactorGraph,
    VariableBlock,
    check_autodiff_factor,
    manifold_dof,
    register_autodiff_factor,
    register_closed_kernel,
    register_factor,
    retract,
)
from .initialize import chordal_init, spanning_tree_init
from .marginalize import marginalize

__all__ = [
    "FactorBatch",
    "FactorGraph",
    "VariableBlock",
    "MANIFOLDS",
    "FACTOR_KERNELS",
    "manifold_dof",
    "register_factor",
    "register_autodiff_factor",
    "check_autodiff_factor",
    "register_closed_kernel",
    "retract",
    "graph_from_numpy",
    "chordal_init",
    "spanning_tree_init",
    "marginalize",
]
