"""Ceres-style Problem API.

Counterpart of ``pyslam_tpu/problem.py``: ``Options``, ``Problem`` with
``add_residual_block``, ``initialize_params``,
``set_parameters_constant`` / ``set_parameters_variable``, ``solve``,
``solve_one_iter``, ``marginalize_parameters``, ``eval_cost``,
``compute_covariance`` and ``get_covariance_block``.

Lowering, as in the reference: named parameters are packed into one
``VariableBlock`` per (manifold, shape), residual blocks are grouped into
``FactorBatch`` es by (kind, loss, camera content), and the solve runs the
structure-dispatching ``solver.solve_auto``.  The measurements of a batch
are stacked on the host and copied to the device once per key
(``residuals.py`` keeps them on the host), so a pose graph of thousands of
blocks costs a handful of copies, not one per block.

Every tensor of the built graph lives on the Problem's device:
``default_device()``, the CUDA card, unless the caller names one
(``device="cpu"``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device
from .graph.core import FactorBatch, FactorGraph, VariableBlock
from .lie.groups import SE2, SE3, SO2, SO3, Sim3, _LieGroupBase
from .losses import L2Loss
from .residuals import DensePriorResidual as _DensePriorResidual
from .residuals import _host
from .solver import lm

# Re-export the solver Options under the reference's name.
Options = lm.Options

_KIND_OF = {SE2: "se2", SE3: "se3", SO2: "so2", SO3: "so3", Sim3: "sim3"}


def _param_kind(value):
    for cls, kind in _KIND_OF.items():
        if isinstance(value, cls):
            return kind
    return "euclidean"


def _loss_key(loss):
    return (type(loss).__name__,) + tuple((f.name, getattr(loss, f.name)) for f in dataclasses.fields(loss))


@dataclasses.dataclass
class _ParamSlot:
    block: str
    index: int
    kind: str
    shape: tuple
    wrapper: type | None


class Problem:
    """Builds and solves a nonlinear least-squares problem (reference API).

    ``dtype`` None is float32 (the reference's default without x64);
    ``device`` None is ``default_device()``, which raises where there is no
    CUDA device."""

    def __init__(self, options: Options | None = None, dtype=None, device=None):
        self.options = options or Options()
        self.dtype = torch.float32 if dtype is None else dtype
        self.device = resolve_device(device)
        self.param_dict: dict = {}
        self.residual_blocks: list = []  # (residual, param_keys, loss)
        self.constant_param_keys: set = set()
        self.summary = None
        self._graph = None
        self._slots: dict[str, _ParamSlot] = {}

    # ------------------------------------------------------------ building
    def add_residual_block(self, residual, param_keys, loss=None):
        if isinstance(param_keys, str):
            param_keys = [param_keys]
        self.residual_blocks.append((residual, list(param_keys), loss or L2Loss()))
        self._graph = None

    def initialize_params(self, param_dict: dict):
        self.param_dict.update(param_dict)
        self._graph = None

    def set_parameters_constant(self, param_keys):
        if isinstance(param_keys, str):
            param_keys = [param_keys]
        self.constant_param_keys.update(param_keys)
        self._graph = None

    def set_parameters_variable(self, param_keys):
        if isinstance(param_keys, str):
            param_keys = [param_keys]
        self.constant_param_keys.difference_update(param_keys)
        self._graph = None

    # ------------------------------------------------------------ lowering
    def _tensor(self, stacked):
        return torch.as_tensor(stacked, dtype=self.dtype).to(self.device)

    def _build(self) -> FactorGraph:
        if self._graph is not None:
            return self._graph
        from .solver.plan_cache import content_key

        # 1. pack named params into per-(kind, shape) variable blocks
        groups: dict = {}
        self._slots = {}
        for name, value in self.param_dict.items():
            kind = _param_kind(value)
            arr = _host(value)
            groups.setdefault((kind, arr.shape), []).append((name, arr))
        blocks = {}
        for (kind, shape), members in groups.items():
            bname = f"{kind}_{'x'.join(map(str, shape)) or 'scalar'}"
            const = np.array([m[0] in self.constant_param_keys for m in members])
            blocks[bname] = VariableBlock.create(kind, self._tensor(np.stack([m[1] for m in members])), const)
            for i, (name, _) in enumerate(members):
                value = self.param_dict[name]
                wrapper = type(value) if isinstance(value, _LieGroupBase) else None
                self._slots[name] = _ParamSlot(bname, i, kind, shape, wrapper)

        # 2. group residual blocks into factor batches
        batch_groups: dict = {}
        for residual, keys, loss in self.residual_blocks:
            # a Lie pose passed as a raw array is inferred 'euclidean' and
            # would fail deep in the assembly: name the parameter here
            expected = getattr(residual, "param_kinds", ())
            if expected and len(expected) == len(keys):
                for kind_e, key in zip(expected, keys):
                    got = self._slots[key].kind
                    if kind_e != got:
                        raise ValueError(
                            f"residual {type(residual).__name__} expects a "
                            f"{kind_e!r} parameter but {key!r} was "
                            f"initialized as {got!r}"
                            + (
                                " — wrap the value in the matching group "
                                "type (pyslam_tpu_torch.SE2/SE3/Sim3)"
                                if got == "euclidean"
                                else ""
                            )
                        )
            data = dict(residual.batch_data())
            cam = data.pop("camera", None)
            # content key, not id: identical cameras merge into one batch
            gkey = (residual.factor_kind, _loss_key(loss), content_key(cam) if cam is not None else None)
            grp = batch_groups.setdefault(gkey, dict(items=[], loss=loss, camera=cam, kind=residual.factor_kind))
            grp["items"].append((data, keys))

        batches = []
        for grp in batch_groups.values():
            items = grp["items"]
            stacked = {k: self._tensor(np.stack([np.asarray(it[0][k]) for it in items])) for k in items[0][0]}
            if grp["camera"] is not None:
                stacked["camera"] = grp["camera"]
            slot_names, indices = [], []
            for s in range(len(items[0][1])):
                slot = [self._slots[it[1][s]] for it in items]
                slot_names.append(slot[0].block)
                indices.append(np.array([sl.index for sl in slot], np.int64))
            batches.append(FactorBatch.create(grp["kind"], tuple(slot_names), tuple(indices), stacked, grp["loss"]))

        self._graph = FactorGraph(blocks, batches)
        return self._graph

    def _writeback(self, graph: FactorGraph):
        for name, slot in self._slots.items():
            val = graph.blocks[slot.block].values[slot.index]
            self.param_dict[name] = slot.wrapper(val) if slot.wrapper is not None else val
        self._graph = graph

    # ------------------------------------------------------------ solving
    def solve(self, mesh=None) -> dict:
        """Optimize all free parameters; returns the updated param_dict
        (reference Problem.solve).  ``solver.solve_auto`` picks the path by
        the graph's structure (dense / sparse Cholesky / ELL PCG / the Schur
        routes); with ``mesh`` (a ``dist.Mesh``) also the sharded routes,
        and ``summary`` is then the cost history of the sharded host loop."""
        from .solver import solve_auto

        solved, info = solve_auto(self._build(), self.options, mesh=mesh)
        self.summary = info
        self._writeback(solved)
        return self.param_dict

    def solve_one_iter(self):
        """One GN/LM step on the dense path (reference
        Problem.solve_one_iter); returns the update norm."""
        solved, dx, _ = lm.solve_one_iter(self._build(), self.options)
        self._writeback(solved)
        return float(torch.linalg.norm(dx))

    def marginalize_parameters(self, param_keys):
        """Remove parameters, folding the information of every residual
        block that touches them into a dense Gaussian prior over their
        Markov blanket (``graph/marginalize.py``).

        The prior becomes an ordinary residual block, so the Problem stays
        rebuildable: blocks and parameters can be added afterwards, and
        solve and covariance work unchanged."""
        from .graph.marginalize import marginalize as _marginalize

        if isinstance(param_keys, str):
            param_keys = [param_keys]
        graph = self._build()
        targets: dict = {}
        for k in param_keys:
            slot = self._slots[k]
            targets.setdefault(slot.block, []).append(slot.index)
        g2 = _marginalize(graph, targets)

        # inverse index remap (marginalize drops rows and shifts indices)
        inv_remap = {}
        for bname, blk in graph.blocks.items():
            drop = set(targets.get(bname, []))
            kept = [i for i in range(blk.n) if i not in drop]
            inv_remap.update({(bname, new_i): old_i for new_i, old_i in enumerate(kept)})
        name_of = {(s.block, s.index): n for n, s in self._slots.items()}

        priors = [fb for fb in g2.batches if fb.kind.startswith("dense_prior__")]
        removed = set(param_keys)
        # g2's dense priors are the whole set: earlier priors pass through
        # marginalize() (merged or consumed), so every DensePriorResidual is
        # dropped here and rebuilt from g2; keeping them too would count
        # their information twice
        self.residual_blocks = [
            rb for rb in self.residual_blocks if not (set(rb[1]) & removed) and not isinstance(rb[0], _DensePriorResidual)
        ]
        for fb in priors:
            weight = fb.weight.tolist()
            index = [ix.tolist() for ix in fb.indices]
            for f in range(fb.n):  # same-kind priors stack into one batch
                if weight[f] == 0.0:
                    continue
                blanket_names = [name_of[(bn, inv_remap[(bn, ix[f])])] for bn, ix in zip(fb.slots, index)]
                kinds = tuple(self._slots[n].kind for n in blanket_names)
                data = {k: v[f] for k, v in fb.data.items()}
                self.residual_blocks.append((_DensePriorResidual(fb.kind, kinds, data), blanket_names, L2Loss()))
        for k in param_keys:
            del self.param_dict[k]
            self.constant_param_keys.discard(k)
        self._graph = None

    def eval_cost(self, param_dict: dict | None = None) -> float:
        """Robustified total cost at the current (or given) params
        (reference Problem.eval_cost)."""
        if param_dict is not None:
            saved = dict(self.param_dict)
            self.param_dict.update(param_dict)
            self._graph = None
            try:
                return float(self._build().chi2())
            finally:
                self.param_dict = saved
                self._graph = None
        return float(self._build().chi2())

    # ----------------------------------------------------------- covariance
    def compute_covariance(self, dense_dof_limit: int = 8192):
        """Posterior covariance (J^T W J)^-1 over the free parameters
        (reference Problem.compute_covariance).

        At or below ``dense_dof_limit`` total dof the full (D, D) matrix is
        formed (``solver.full_covariance``).  Above it no (D, D) is formed:
        the covariance goes lazy and ``get_covariance_block`` answers each
        query by selective column solves (``solver/covariance.py``).
        Returns the dense matrix, or None in lazy mode."""
        graph = self._build()
        if graph.total_dof <= dense_dof_limit:
            from .solver.covariance import full_covariance

            self._covariance = full_covariance(graph)
        else:
            self._covariance = None
        return self._covariance

    def get_covariance_block(self, param_key_1: str, param_key_2: str):
        """Covariance block between two named parameters (reference API),
        in dense and lazy mode alike (see compute_covariance)."""
        if not hasattr(self, "_covariance"):
            self.compute_covariance()
        graph = self._build()
        s1, s2 = self._slots[param_key_1], self._slots[param_key_2]

        if self._covariance is None:  # lazy: selective solves, no (D, D)
            from .solver import route_auto
            from .solver.covariance import (
                covariance_block,
                landmark_covariance_block,
                pose_covariance_block,
                pose_landmark_covariance_block,
            )

            if len(graph.blocks) == 1:
                return covariance_block(graph, s1.index, s2.index)
            kinds = {n: b.kind for n, b in graph.blocks.items()}
            lie = [n for n, k in kinds.items() if k != "euclidean"]
            euc = [n for n, k in kinds.items() if k == "euclidean"]
            # bundle adjustment: one Lie and one euclidean block and an
            # observation batch between them in EITHER slot order (the
            # reference sees only (pose, landmark) and raises on the other)
            if (
                len(graph.blocks) == 2
                and len(lie) == 1
                and len(euc) == 1
                and any(tuple(fb.slots) in ((lie[0], euc[0]), (euc[0], lie[0])) for fb in graph.batches)
            ):
                # where the solve takes the factored sparse S, so do the
                # S-solves: exact, no PCG tolerance
                m = "sparse" if route_auto(graph) == "schur_sparse" else "pcg"
                kw = dict(pose_name=lie[0], lm_name=euc[0], method=m)
                if s1.block == lie[0] and s2.block == lie[0]:
                    return pose_covariance_block(graph, s1.index, s2.index, **kw)
                if s1.block == euc[0] and s2.block == euc[0]:
                    return landmark_covariance_block(graph, s1.index, s2.index, **kw)
                if s1.block == lie[0] and s2.block == euc[0]:
                    return pose_landmark_covariance_block(graph, s1.index, s2.index, **kw)
                if s1.block == euc[0] and s2.block == lie[0]:
                    return pose_landmark_covariance_block(graph, s2.index, s1.index, **kw).T
            raise ValueError(
                "lazy covariance supports single-block graphs and "
                "camera+landmark graphs; raise dense_dof_limit for other "
                "block structures"
            )

        offsets = graph.offsets()

        def span(slot):
            dof = graph.blocks[slot.block].dof
            start = offsets[slot.block] + slot.index * dof
            return start, start + dof

        (a0, a1), (b0, b1) = span(s1), span(s2)
        return self._covariance[a0:a1, b0:b1]


__all__ = ["Problem", "Options"]
