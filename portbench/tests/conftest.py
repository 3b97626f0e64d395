"""The benchmark's own tests: on the CPU at small sizes, each case that needs
a CUDA card skipping without one.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(params=["cpu", "cuda"])
def device(request):
    """Each device a case runs on; the card's cases skip without one."""
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param


def small_config(cell: str) -> dict:
    """The cell's configuration as committed, at the sizes its file gives
    for a test run (``test_sizes``, which the run itself never reads)."""
    from portbench import harness

    manifest = harness.load_manifest(ROOT)
    cfg = harness.config_of(manifest, harness.cell_of(manifest, cell)["config"], ROOT)
    cfg["sizes"].update(cfg["test_sizes"])
    return cfg
