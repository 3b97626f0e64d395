"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file that the harness finds by that name."""

import importlib
import json
import re

import pytest
from conftest import ROOT

from portbench import judge

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|per_tok")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert all(_line(w) for w in MANIFEST["command"]) and len(MANIFEST["command"]) <= 32
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_the_run_length_fits_a_check_of_24_cells():
    runs, per_run = 2 + 14 * 24, MANIFEST["run_seconds"] + 60
    assert runs * per_run + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_configuration(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"]) and _line(config["source"]) and _line(config["why"])
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert sorted(data["reduced"]) == sorted(config["reduced"]) and len(config["reduced"]) <= 16
    for key in config["reduced"]:
        assert NAME.match(key) and key in data["sizes"] and not WIDTH.search(key)
    assert any(w["config"] == config["name"] for w in MANIFEST["workloads"])
    for part in ("generator", "entry", "reference"):
        folder = {"generator": "generators", "entry": "entries", "reference": "references"}[part]
        assert (ROOT / "portbench" / folder / f"{data[part]}.py").is_file()
    assert set(data["limits"]) == set(judge.NUMBERS)


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and _line(cell["why"])
    assert cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in MANIFEST["configs"]}
    assert (ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").is_file()
    reported = [m for m in MANIFEST["end_to_end"] if "workloads" not in m or cell["name"] in m["workloads"]]
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert any("workloads" not in m or cell["name"] in m["workloads"] for m in MANIFEST["per_layer"])


def test_cells_and_names_are_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in MANIFEST[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(1, len(MANIFEST["workloads"]) // 4)


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_metric(metric):
    end_to_end = metric in MANIFEST["end_to_end"]
    keys = {"name", "unit", "better", "source"} | ({"bound"} if end_to_end else {"layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if end_to_end:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert _line(metric["layer"])
        moves = next(m for m in MANIFEST["end_to_end"] if m["name"] == metric["moves"])
        for cell in metric.get("workloads", cells):
            assert "workloads" not in moves or cell in moves["workloads"]
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"
    module = importlib.import_module(f"portbench.metrics.{metric['name']}")
    assert callable(module.read)


def test_setup_bound():
    (setup,) = [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"]
    assert setup["bound"] == 0.25


def test_every_file_under_paths_is_named_from_name_characters():
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
