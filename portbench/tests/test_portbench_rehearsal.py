"""A rehearsal of the next cell: in a copy of the benchmark, a cell added by
a configuration file of its own and entries appended to BENCHMARK.json,
nothing else; the cell reports every metric of its path, and the
benchmark's own tests of that cell pass there."""

import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

from conftest import ROOT

from portbench import harness

NAME = "sphere_rehearsal"
CELL = f"{NAME}.solve"
LIKE = "sphere30k.solve"
TESTS = ("test_portbench_manifest", "test_portbench_cells", "test_portbench_faults", "test_portbench_spans")
APPENDED = ("configs", "workloads", "end_to_end", "per_layer")


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in (root / "portbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _copy_with_a_new_cell(root):
    """The benchmark copied under ``root``, with one cell added as a later
    PR adds one: a renamed copy of ``sphere30k``'s configuration with test
    sizes of its own, its ``configs`` and ``workloads`` entries, and its
    path's metrics that list their cells, each appended as
    ``<metric>.<config>`` listing the new cell."""
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    (sphere,) = [c for c in manifest["configs"] if c["name"] == "sphere30k"]
    cfg = json.loads((ROOT / sphere["file"]).read_text())
    cfg.update(name=NAME, test_sizes={"n_poses": 200})
    (root / "portbench" / "configs" / f"{NAME}.json").write_text(json.dumps(cfg, indent=2))
    manifest["configs"].append(dict(sphere, name=NAME, file=f"portbench/configs/{NAME}.json"))
    manifest["workloads"].append({"name": CELL, "config": NAME, "traffic": "solve", "chips": 1,
                                  "why": "a rehearsal of a cell added by new files and appended entries alone"})
    for group in ("end_to_end", "per_layer"):
        manifest[group] += [dict(m, name=f"{m['name']}.{NAME}", workloads=[CELL])
                            for m in manifest[group] if LIKE in m.get("workloads", ())]
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))


def _pytest(root, *args):
    """The copy's own tests, with the copy's ``portbench`` first on the path
    and the program from this checkout."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(ROOT)]))
    where = subprocess.run([sys.executable, "-c", "import portbench; print(portbench.__file__)"], cwd=root, env=env,
                           capture_output=True, text=True, timeout=120)
    assert where.stdout.strip() == str(root / "portbench" / "__init__.py"), where
    return subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                           *args], cwd=root, env=env, capture_output=True, text=True, timeout=1200)


def test_a_cell_from_new_files_and_appended_entries_passes_the_tests(tmp_path):
    _copy_with_a_new_cell(tmp_path)
    # the copy differs from the benchmark by the new file and the appended entries alone
    before, after = _files(ROOT), _files(tmp_path)
    assert set(after) - set(before) == {f"portbench/configs/{NAME}.json"}
    assert all(after[k] == v for k, v in before.items())
    old, new = (json.loads((r / "BENCHMARK.json").read_text()) for r in (ROOT, tmp_path))
    assert {k: v for k, v in new.items() if k not in APPENDED} == {k: v for k, v in old.items() if k not in APPENDED}
    for key in APPENDED:
        assert new[key][:len(old[key])] == old[key]
    # the new cell reports what sphere30k reports, each by the same reader
    for trace in (False, True):
        reads = [sorted((harness.reader_name(m["name"]), m["unit"]) for m in harness.metrics_for(new, c, trace))
                 for c in (LIKE, CELL)]
        assert reads[0] == reads[1] and len(reads[0]) == len(harness.metrics_for(old, LIKE, trace))
    report = tmp_path / "report.xml"
    run = _pytest(tmp_path, *(f"portbench/tests/{t}.py" for t in TESTS), "-k", NAME, f"--junitxml={report}")
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    passed = [c.get("classname", "") for c in ET.parse(report).iter("testcase") if not len(c)]
    assert all(any(t in c for c in passed) for t in TESTS), passed
