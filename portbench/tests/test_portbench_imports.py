"""What the benchmark loads: never JAX, never the JAX package, compared by
whole top-level module name; the plain references nothing of the program;
nothing read from the JAX package's benchmark."""

import ast
import subprocess
import sys

import pytest
from conftest import ROOT

from portbench import run

FILES = sorted(p for p in (ROOT / "portbench").rglob("*.py") if "__pycache__" not in p.parts)
# the plain references and what they are built from
REFERENCE_FILES = sorted((ROOT / "portbench" / "references").glob("*.py")) + [
    ROOT / "portbench" / "lie.py", ROOT / "portbench" / "arith.py", ROOT / "portbench" / "judge.py"]


def _imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("names,found", [
    (["pyslam_tpu_torch", "pyslam_tpu_torch.solver", "torch", "numpy"], []),
    (["pyslam_tpu.solver", "torch"], ["pyslam_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jax_utils", "flaxen", "pyslam_tpu_tools"], []),
])
def test_forbidden_names_are_whole_top_level_names(names, found):
    assert run.forbidden_modules(names) == found


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imported_tops(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", REFERENCE_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_the_references_import_nothing_of_the_program(path):
    assert "pyslam_tpu_torch" not in _imported_tops(path)
    assert "pyslam_tpu_torch" not in path.read_text()


@pytest.mark.parametrize("path", [p for p in FILES if "tests" not in p.parts], ids=lambda p: p.relative_to(ROOT).as_posix())
def test_nothing_reads_the_jax_package_benchmark(path):
    text = path.read_text()
    for name in ('"bench/', "'bench/", "bench.py", "BENCH_", "MULTICHIP_", "baseline_cache", "standin_cache"):
        assert name not in text


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Import everything a run imports, in a fresh process, then look."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.run, portbench.harness, portbench.calibrate, pyslam_tpu_torch\n"
        "import importlib, pathlib\n"
        "for sub in ('entries', 'generators', 'references', 'metrics'):\n"
        "    for p in sorted(pathlib.Path(%r, 'portbench', sub).glob('*.py')):\n"
        "        importlib.import_module(f'portbench.{sub}.{p.stem}')\n"
        "import pyslam_tpu_torch.solver.schur_large, pyslam_tpu_torch.solver.bcsr\n"
        "print(portbench.run.forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
