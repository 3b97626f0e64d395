"""The twin of ``tests/test_hygiene.py``: the repository's cache policy,
applied to the port.  Caches are content-keyed, never ``id()``-keyed, and
plan caches do not grow when callers pass fresh plans of identical content.

Held here, against the port's ``solver/plan_cache.py``:
  * ``TestNoIdKeyedCaches::test_no_id_calls_in_package``, over
    ``pyslam_tpu_torch/`` (the one sanctioned use: ``plan_cache.py``'s
    id->key memo, evicted by a weakref finalizer);
  * ``TestContentKey::test_same_content_same_key``,
    ``::test_different_content_different_key`` (the port's and the
    reference's ELL plans of the same graphs, keyed alike),
    ``::test_memo_does_not_pin_and_never_staleness``;
  * ``TestContentKey::test_closure_cache_bounded``: the port's
    ``ClosureCache`` holds plans, not compiled closures (the port compiles
    nothing), and is bounded the same way;
  * ``TestPlanCacheReuse::test_fresh_identical_plans_share_one_entry``:
    repeated ``solve_schur_sqrt`` calls without a plan keep one entry of
    ``schur_sqrt._CLOSURES``.

It also holds the rule that every test function of the reference files
that have no ``test_torch_`` file of the same name is named in the
docstring of its twin, either with the port test that holds it
(``test_torch_<file>.py::<test>``, which must exist) or with the reason it
has no meaning for the port (``test_every_reference_case_is_accounted_for``).
"""

import ast
import dataclasses
import gc
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.solver import plan_cache as jplan_cache
from pyslam_tpu.solver.bcsr import build_ell_direct as j_build_ell_direct
from pyslam_tpu_torch.graph import build
from pyslam_tpu_torch.io import synth
from pyslam_tpu_torch.solver import Options, plan_cache, schur_sqrt
from pyslam_tpu_torch.solver.bcsr import build_ell_direct
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "pyslam_tpu_torch"


def test_no_id_calls_in_package():
    """``id(x)`` appears nowhere in the port's source but the memo of
    ``plan_cache.py``: its keys are evicted by a weakref finalizer, so a
    recycled id can never alias.  Docstring mentions of ``id()`` (empty
    parens) are allowed."""
    pat = re.compile(r"\bid\([^)]+\)")
    offenders, sanctioned = [], []
    for f in sorted(PKG.rglob("*.py")):
        for ln, line in enumerate(f.read_text().splitlines(), 1):
            if pat.search(line):
                (sanctioned if f.name == "plan_cache.py" else offenders).append(
                    f"{f.relative_to(ROOT)}:{ln}: {line.strip()}")
    assert not offenders, "id()-keyed code found:\n" + "\n".join(offenders)
    assert sanctioned == ["pyslam_tpu_torch/solver/plan_cache.py:67: oid = id(obj)"]


def _plans(n_poses):
    data = dict(n_poses=n_poses, n_loops=2, seed=3)
    g = build.pose_graph(synth.se2_loop(**data), dtype=torch.float64, device="cpu")
    jg = jbuild.pose_graph(jsynth.se2_loop(**data), dtype=jnp.float64)
    return (build_ell_direct(g), build_ell_direct(g)), (j_build_ell_direct(jg), j_build_ell_direct(jg))


def test_same_content_same_key():
    (p1, p2), (j1, j2) = _plans(12)
    assert p1 is not p2
    assert plan_cache.content_key(p1) == plan_cache.content_key(p2)
    assert plan_cache.content_key(p1) == plan_cache.content_key(p1)  # the memoized digest
    assert jplan_cache.content_key(j1) == jplan_cache.content_key(j2)


def test_different_content_different_key():
    (p12, _), (j12, _) = _plans(12)
    (p13, _), (j13, _) = _plans(13)
    assert plan_cache.content_key(p12) != plan_cache.content_key(p13)
    assert jplan_cache.content_key(j12) != jplan_cache.content_key(j13)


def test_memo_does_not_pin_and_never_goes_stale():
    """After an object dies its memo entry goes, so a recycled id re-hashes."""

    @dataclasses.dataclass
    class P:
        a: np.ndarray

    p = P(np.arange(4.0))
    k = plan_cache.content_key(p)
    oid = id(p)
    assert plan_cache._MEMO.get(oid) == k
    del p
    gc.collect()
    assert oid not in plan_cache._MEMO  # the finalizer evicted the entry
    t = torch.arange(4.0)
    assert plan_cache.content_key(P(t)) == plan_cache.content_key(P(t.clone()))


def test_closure_cache_bounded():
    c = plan_cache.ClosureCache(maxsize=4)
    for i in range(10):
        c[("k", i)] = i
    assert len(c) == 4
    assert ("k", 9) in c and ("k", 5) not in c
    assert c[("k", 6)] == 6  # a read moves its entry to the back
    c[("k", 10)] = 10
    assert ("k", 6) in c and ("k", 7) not in c


def test_fresh_identical_plans_share_one_entry():
    """Repeated ``solve_schur_sqrt`` calls without a plan (each builds a
    fresh plan) do not grow its cache."""
    data = synth.ba_synthetic(n_cams=4, n_pts=12, obs_per_pt=3, seed=5)
    g = build.ba_graph(data, dtype=torch.float64, device="cpu")
    opts = Options(method="lm", max_iters=3)
    _, first = schur_sqrt.solve_schur_sqrt(g, opts)
    n_after_first = len(schur_sqrt._CLOSURES)
    for _ in range(3):
        _, again = schur_sqrt.solve_schur_sqrt(g, opts)
        assert torch.equal(again.chi2, first.chi2)
    assert len(schur_sqrt._CLOSURES) == n_after_first


# The reference test files with no port file of the same name when the port
# began to hold them; each has its twin, tests/test_torch_<name>.py.
TWINS = ["comm_model", "debug", "hygiene", "integration", "landmark_slam", "metrics", "observability", "sim3",
         "solver", "utils"]


def _reference_cases(path):
    """``Class::test`` or ``test`` of every test function of a test file."""
    out = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
            out.append(node.name)
        elif isinstance(node, ast.ClassDef):
            out += [f"{node.name}::{f.name}" for f in node.body
                    if isinstance(f, ast.FunctionDef) and f.name.startswith("test_")]
    return out


@pytest.mark.parametrize("name", TWINS)
def test_every_reference_case_is_accounted_for(name):
    """Every test function of ``tests/test_<name>.py`` is named in the
    docstring of ``tests/test_torch_<name>.py`` (as ``::test_...``), and
    every port test the docstring names as its holder exists."""
    cases = _reference_cases(ROOT / "tests" / f"test_{name}.py")
    twin = ROOT / "tests" / f"test_torch_{name}.py"
    doc = ast.get_docstring(ast.parse(twin.read_text()))
    assert cases and doc
    missing = [c for c in cases if not re.search(rf"::{c.split('::')[-1]}\b", doc)]
    assert not missing, f"{twin.name} does not account for {missing}"
    for file, test in re.findall(r"(test_torch_\w+\.py)::(test_\w+)", " ".join(doc.split())):
        assert re.search(rf"^def {test}\(", (ROOT / "tests" / file).read_text(), re.M), f"{file}::{test}"
