"""The comparison that decides ``correct`` has to fail what is wrong: the
control (the plain reference in TF32 put in the program's place) and each
fault a cell can have, planted under a whole run at a small size.  Each
entry into the program brings its faults in a module of its own,
``faults/<entry>.py``, which defines every name of ``FAULTS``.  The fault
of an exchange between cards left out has no place in these cells: each
runs on one card."""

import importlib
import importlib.util
import pathlib
import time

import pytest
import torch
from conftest import ROOT, small_config

from portbench import harness
from portbench.arith import Arith

MANIFEST = harness.load_manifest(ROOT)
CELLS = [w["name"] for w in MANIFEST["workloads"]]
FAULTS = ("state_unchanged", "half_left_out", "chi2_altered", "variable_altered")


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


def plant(entry: str, fault: str, monkeypatch):
    """Plant a fault of the entry's own module, ``faults/<entry>.py`` beside
    this file; fail, naming what is missing, where there is none."""
    path = pathlib.Path(__file__).resolve().parent / "faults" / f"{entry}.py"
    if not path.is_file():
        pytest.fail(f"no faults module {path.relative_to(ROOT)} for the entry {entry!r}")
    spec = importlib.util.spec_from_file_location(f"portbench_faults_{entry}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not callable(getattr(module, fault, None)):
        pytest.fail(f"{path.relative_to(ROOT)} defines no fault {fault!r}")
    getattr(module, fault)(monkeypatch)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, device, monkeypatch):
    plant(small_config(cell)["entry"], fault, monkeypatch)
    result = _run(cell, device)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_same_run_without_a_fault_is_correct(cell, device):
    assert _run(cell, device)["correct"] is True


@pytest.mark.parametrize("entry,fault,message", [
    ("solve_ell", "no_such_fault", "defines no fault 'no_such_fault'"),
    ("no_such_entry", "state_unchanged", "no faults module portbench/tests/faults/no_such_entry.py"),
])
def test_a_fault_its_module_lacks_fails_by_name(entry, fault, message, monkeypatch):
    with pytest.raises(pytest.fail.Exception, match=message):
        plant(entry, fault, monkeypatch)
