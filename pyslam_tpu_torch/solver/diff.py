"""Differentiable solving: gradients through the converged solution.

Counterpart of ``pyslam_tpu/solver/diff.py``.  ``solve_implicit`` returns
the optimized variable values as a function of the factor measurements
(the floating-point tensors of every ``FactorBatch.data``), differentiable
in reverse mode by the implicit function theorem, with no unrolling of the
LM iterations:

    at the optimum:  grad_x chi2(x*, theta) = 0
    =>  dx*/dtheta = -H^-1 d(grad_x chi2)/dtheta      (H = GN Hessian)

The backward of a cotangent ct on the solved values, in three steps:
    1. pull ct back to the tangent space (<ct, G_i X*> for the left
       generators of SE(n) / SO(n); the identity for euclidean blocks),
       zero on constant elements;
    2. solve H y = ct_t with the dense assembly at the optimum;
    3. -y^T d(grad chi2)/dtheta, plus the envelope term of chi2*, by one
       ``torch.autograd.grad`` through the tangent gradient.  Its segment
       sums are the ``slot_reduce`` kernel on the card, differentiable
       through ``cuda_ops._SlotReduce``.

Uses: calibration learning, training a learned front end against the
solver, sensitivity analysis.
"""

from __future__ import annotations

import torch

from ..graph.core import FactorBatch, FactorGraph, VariableBlock
from . import lm as _lm
from .assemble import assemble_dense, gradient_and_chi2
from .linear import cholesky_solve


def _tangent_cotangent(block, ct_values):
    """Pull a cotangent on the (batched) matrix values back to the tangent
    space of left-multiplicative perturbations: ct_t[i] = <ct, d/d eps_i
    exp(eps) X> = <ct, G_i X>."""
    kind = block.kind
    X = block.values
    if kind == "euclidean":
        return ct_values.reshape(X.shape[0], -1)
    if kind == "so2":
        G = torch.tensor([[0.0, -1.0], [1.0, 0.0]], dtype=X.dtype, device=X.device)[None]  # (1, 2, 2)
    elif kind in ("se3", "se2", "so3"):
        from ..lie import se2, se3, so3

        ops = {"se3": se3, "se2": se2, "so3": so3}[kind]
        dof = {"se3": 6, "se2": 3, "so3": 3}[kind]
        G = ops.wedge(torch.eye(dof, dtype=X.dtype, device=X.device))  # (dof, n, n): the generators
    else:
        raise ValueError(f"unsupported kind {kind!r}")
    GX = torch.einsum("dij,bjk->bdik", G, X)
    return torch.einsum("bik,bdik->bd", ct_values, GX)


def _with_data(graph: FactorGraph, data_list, blocks=None) -> FactorGraph:
    batches = [FactorBatch(fb.kind, fb.slots, fb.indices, data, fb.loss, fb.weight)
               for fb, data in zip(graph.batches, data_list)]
    return FactorGraph(graph.blocks if blocks is None else blocks, batches)


def _tangent_gradient(graph: FactorGraph):
    """(grad_x chi2 over the global tangent space, chi2), as functions of
    the factor data for the theta-VJP; constant elements masked.  The
    reference takes the gradient from its dense assembly; only g is needed,
    so H is not formed."""
    g, chi2 = gradient_and_chi2(graph)
    return -g, chi2  # the assembly's g is -grad


class _ImplicitSolve(torch.autograd.Function):
    """Inputs (skeleton, options, keys, *leaves): ``keys[i]`` is (batch,
    key) of leaf i.  Outputs: the solved values of every block in the
    graph's block order, then chi2."""

    @staticmethod
    def forward(ctx, skeleton, options, keys, *leaves):
        data_list = _data_list(skeleton, keys, leaves)
        solved, info = _lm.solve(_with_data(skeleton, data_list), options)
        # copies: a block the solve left as it was is the caller's own
        # tensor, which an output of the Function would tie into the graph
        values = tuple(b.values.clone() for b in solved.blocks.values())
        ctx.skeleton, ctx.keys = skeleton, keys
        ctx.save_for_backward(*values, *leaves)
        return (*values, info.chi2)

    @staticmethod
    def backward(ctx, *cts):
        skeleton, keys = ctx.skeleton, ctx.keys
        n_blocks = len(skeleton.blocks)
        saved = ctx.saved_tensors
        values, leaves = saved[:n_blocks], saved[n_blocks:]
        ct_values, ct_chi2 = cts[:n_blocks], cts[n_blocks]
        blocks = {n: VariableBlock(b.kind, v, b.const_mask) for (n, b), v in zip(skeleton.blocks.items(), values)}

        # 1. the cotangent in the tangent space, zero on constant elements
        segs = []
        for b, ct in zip(blocks.values(), ct_values):
            ct_t = _tangent_cotangent(b, ct)
            segs.append(torch.where(b.const_mask[:, None], 0.0, ct_t).reshape(-1))
        ct_flat = torch.cat(segs)

        # 2. H y = ct_t at the optimum (the masking of the forward assembly)
        g_star = _with_data(skeleton, _data_list(skeleton, keys, leaves), blocks)
        H, _, _ = assemble_dense(g_star)
        y = cholesky_solve(H, ct_flat)
        del H

        # 3. -y^T d(grad chi2)/dtheta and the envelope term of chi2*: at the
        # optimum grad_x chi2 = 0, so d chi2*/dtheta is the direct partial
        with torch.enable_grad():
            leaves_g = tuple(leaf.detach().requires_grad_() for leaf in leaves)
            grad_x, chi2 = _tangent_gradient(_with_data(skeleton, _data_list(skeleton, keys, leaves_g), blocks))
            grads = torch.autograd.grad((grad_x, chi2), leaves_g, grad_outputs=(-y, ct_chi2), allow_unused=True)
        grads = tuple(torch.zeros_like(leaf) if gr is None else gr for leaf, gr in zip(leaves, grads))
        return (None, None, None, *grads)


def _data_list(skeleton, keys, leaves):
    data_list = [dict(fb.data) for fb in skeleton.batches]
    for (b, k), leaf in zip(keys, leaves):
        data_list[b][k] = leaf
    return data_list


def solve_implicit(graph: FactorGraph, options: _lm.Options = _lm.Options()):
    """Solve and return ``(values_dict, chi2)``, where ``values_dict``
    (block name -> solved values) and chi2 are differentiable with respect
    to every floating-point tensor of every ``FactorBatch.data``
    (measurements, information weights, ...).

    The forward is ``lm.solve`` on the dense path; the backward assembles
    the dense H once at the optimum, so this suits the small and medium
    problems where gradients are wanted."""
    keys, leaves = [], []
    data_list = []
    for b, fb in enumerate(graph.batches):
        rest = {}
        for k, v in fb.data.items():
            if torch.is_tensor(v) and v.is_floating_point():
                keys.append((b, k))
                leaves.append(v)
            else:
                rest[k] = v
        data_list.append(rest)
    # the data-free skeleton: every differentiable tensor enters as an input
    skeleton = _with_data(graph, data_list)
    out = _ImplicitSolve.apply(skeleton, options, tuple(keys), *leaves)
    values = dict(zip(graph.blocks, out[:-1]))
    return values, out[-1]


__all__ = ["solve_implicit"]
