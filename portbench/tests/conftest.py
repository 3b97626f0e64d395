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


# sizes a test run holds, each cell's configuration otherwise as committed
SMALL = {
    "venice_ba.solve": dict(n_cams=12, n_pts=1500, n_obs=6000),
    "sphere30k.solve": dict(n_poses=300),
}


def small_config(cell: str) -> dict:
    import copy

    from portbench import harness

    manifest = harness.load_manifest(ROOT)
    cfg = copy.deepcopy(harness.config_of(manifest, harness.cell_of(manifest, cell)["config"], ROOT))
    cfg["sizes"].update(SMALL[cell])
    return cfg
