"""The comparison that decides ``correct`` has to fail what is wrong: the
control (the plain reference in TF32 put in the program's place) and each
fault a cell can have, planted under a whole run at a small size.  The
fault of an exchange between cards left out has no place in these cells:
each runs on one card."""

import importlib
import time

import pytest
import torch
from conftest import ROOT, small_config

from portbench import harness
from portbench.arith import Arith

MANIFEST = harness.load_manifest(ROOT)
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _entry(cell):
    cfg = small_config(cell)
    return cfg, importlib.import_module(f"portbench.entries.{cfg['entry']}")


def _run(cell, device, seed=4242):
    return harness.run_cell(MANIFEST, cell, seed, 0.3, False, device, time.perf_counter(), config=small_config(cell))


def _keep_problem(monkeypatch, entry):
    build = entry.build

    def keeping(problem, config, device):
        state = build(problem, config, device)
        state["problem"] = problem
        return state

    monkeypatch.setattr(entry, "build", keeping)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_the_control_is_not_correct(cell, seed, device, monkeypatch):
    cfg, entry = _entry(cell)
    ref = importlib.import_module(f"portbench.references.{cfg['reference']}")
    _keep_problem(monkeypatch, entry)
    monkeypatch.setattr(entry, "solve", lambda state: ref.solve(state["problem"], state["config"],
                                                                Arith(torch.float32, tf32=True)))
    result = _run(cell, device, seed)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def _state_unchanged(monkeypatch):
    from pyslam_tpu_torch.graph.core import FactorGraph
    from pyslam_tpu_torch.solver import schur_large

    monkeypatch.setattr(schur_large, "_back_substitute_retract",
                        lambda parts, Hll_inv, poses, lms, x: ((poses, lms), x.new_zeros(())))
    monkeypatch.setattr(FactorGraph, "retract_all", lambda self, dx: self)


def _half_left_out(monkeypatch):
    """The second half of the observations or edges weigh nothing."""
    from pyslam_tpu_torch.solver import bcsr, schur_large

    obs_rows = schur_large._obs_rows

    def half_rows(plan, poses, lms):
        cost, rows = obs_rows(plan, poses, lms)
        cost[plan.M // 2:] = 0
        rows[plan.M // 2:] = 0
        return cost, rows

    monkeypatch.setattr(schur_large, "_obs_rows", half_rows)
    batches = bcsr.ell_assemble_batches

    def half_batches(graph):
        out = batches(graph)
        if out is None:
            return None
        halved = []
        for b in out:
            w = b.weight.clone()
            w[w.shape[0] // 2:] = 0
            halved.append(b._replace(weight=w))
        return halved

    monkeypatch.setattr(bcsr, "ell_assemble_batches", half_batches)


def _altered(what):
    def plant(monkeypatch):
        """The answer altered where the program makes it: the chi2 it
        reports 1% high, or one landmark or pose moved by 0.1."""
        from pyslam_tpu_torch.graph.core import FactorGraph, VariableBlock
        from pyslam_tpu_torch.solver import bcsr, schur_large

        def moved(graph):
            name = "landmarks" if "landmarks" in graph.blocks else "poses"
            b = graph.blocks[name]
            v = b.values.clone()
            if name == "landmarks":
                v[v.shape[0] // 2] += 0.1
            else:
                v[v.shape[0] // 2, :3, 3] += 0.1
            return FactorGraph({**graph.blocks, name: VariableBlock(b.kind, v, b.const_mask)}, graph.batches)

        large = schur_large.solve_schur_large

        def large_altered(*args, **kwargs):
            graph, chi2, history = large(*args, **kwargs)
            return (graph, chi2 * 1.01, history) if what == "chi2" else (moved(graph), chi2, history)

        ell = bcsr.solve_ell

        def ell_altered(*args, **kwargs):
            graph, info = ell(*args, **kwargs)
            return (graph, info._replace(chi2=info.chi2 * 1.01)) if what == "chi2" else (moved(graph), info)

        monkeypatch.setattr(schur_large, "solve_schur_large", large_altered)
        monkeypatch.setattr(bcsr, "solve_ell", ell_altered)
    return plant


FAULTS = {"state_unchanged": _state_unchanged, "half_left_out": _half_left_out,
          "chi2_altered": _altered("chi2"), "variable_altered": _altered("variable")}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, device, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = _run(cell, device)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_same_run_without_a_fault_is_correct(cell, device):
    assert _run(cell, device)["correct"] is True
