"""A rehearsal of each cell's whole run at a small size, with the device
passed explicitly, and the result line's contract."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch
from conftest import ROOT, small_config

from portbench import harness, judge, run

MANIFEST = harness.load_manifest(ROOT)
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _run(cell, device, trace, seed=2**31 + 99):
    return harness.run_cell(MANIFEST, cell, seed, 0.5, trace, device, time.perf_counter(), config=small_config(cell))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_at_a_small_size_is_correct(cell, trace, device):
    result = _run(cell, device, trace)
    line = json.dumps(result, allow_nan=False)  # one line of plain JSON
    assert "\n" not in line
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    dev = result["device"]
    assert dev["platform"] == ("gpu" if device == "cuda" else "cpu") and dev["count"] == 1
    assert isinstance(dev["memory_peak_bytes"], int)
    for name, c in result["checks"].items():
        assert name in judge.NUMBERS and c["value"] <= c["limit"]
    expected = {m["name"]: m["unit"] for m in harness.metrics_for(MANIFEST, cell, trace)}
    for name, m in result["metrics"].items():
        assert m["unit"] == expected[name] and m["value"] == m["value"]
    if not trace:
        assert set(result["metrics"]) == set(expected)
        assert "breakdown" not in result
    else:
        assert {"busy_s", "window_s"} <= set(dev) and "breakdown" in result
        # what the probes and counters read is there on any device
        assert {"plan_ms", "lm_iterations", "host_reads"} <= set(result["metrics"])
        if device == "cuda":
            assert dev["busy_s"] > 0 and {"kernels_per_solve", "device_idle_pct"} <= set(result["metrics"])
            assert all(len(result["breakdown"][k]) <= 10 for k in ("device_ops", "idle_gaps"))


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_the_benchmark_alone_cannot_run(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files but not the
    program: the run fails and prints nothing."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    cli = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert cli.returncode != 0 and cli.stdout == ""
    code = ("import sys, time; sys.path.insert(0, '.'); from portbench import harness\n"
            f"harness.run_cell(harness.load_manifest(), {CELLS[0]!r}, 1, 0.1, False, 'cpu', time.perf_counter())\n")
    direct = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert direct.returncode != 0 and direct.stdout == "" and "pyslam_tpu_torch" in direct.stderr
