"""The port's copy of the g2o reader/writer against the reference's
(``pyslam_tpu/io/g2o.py``; both numpy only): the writers give identical
file bytes and the readers identical arrays, for SE(2), SE(3), Sim(3),
2D landmark and switchable-constraint files.  Tolerance: exact.

The port's ``read_g2o_switchable`` also validates the vertex ids of
switchable edges, which the reference passes through unchecked: an id
outside [0, n_poses) and a file with landmark records both raise.
"""

import dataclasses

import numpy as np
import pytest

from pyslam_tpu.io import g2o as jg2o
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu_torch.io import g2o as tg2o
from pyslam_tpu_torch.io import synth as tsynth
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

DATASETS = {
    "se2_manhattan": lambda s: s.se2_manhattan(n_poses=200, seed=1),
    "se3_sphere": lambda s: s.se3_sphere(n_poses=40, seed=2),
    "sim3_loop": lambda s: s.sim3_loop(n_poses=40, n_loops=3, scale_drift=0.005, seed=0),
}


def _assert_same(out, ref):
    assert type(out).__name__ == type(ref).__name__
    for f in dataclasses.fields(ref):
        a, b = getattr(out, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_write_and_read_match_reference(name, tmp_path):
    ref_path, out_path = tmp_path / "ref.g2o", tmp_path / "out.g2o"
    jg2o.write_g2o(ref_path, DATASETS[name](jsynth))
    tg2o.write_g2o(out_path, DATASETS[name](tsynth))
    assert out_path.read_bytes() == ref_path.read_bytes()
    _assert_same(tg2o.read_g2o(out_path), jg2o.read_g2o(ref_path))


def test_landmark_file_matches_reference(tmp_path):
    data = jsynth.landmark_slam_2d(n_poses=30, n_landmarks=10, obs_type="xy", seed=3)
    ref_path, out_path = tmp_path / "ref.g2o", tmp_path / "out.g2o"
    jg2o.write_g2o_landmarks(ref_path, data)
    tg2o.write_g2o_landmarks(out_path, data)
    assert out_path.read_bytes() == ref_path.read_bytes()
    _assert_same(tg2o.read_g2o(out_path), jg2o.read_g2o(ref_path))


def test_switchable_file_matches_reference(tmp_path):
    data = jsynth.se2_loop(n_poses=30, n_loops=4, seed=0)
    loop = np.abs(np.asarray(data.edges_i) - np.asarray(data.edges_j)) != 1
    ref_path, out_path = tmp_path / "ref.g2o", tmp_path / "out.g2o"
    jg2o.write_g2o_switchable(ref_path, data, loop, xi=3.0)
    tg2o.write_g2o_switchable(out_path, data, loop, xi=3.0)
    assert out_path.read_bytes() == ref_path.read_bytes()
    (d_out, sw_out), (d_ref, sw_ref) = tg2o.read_g2o_switchable(out_path), jg2o.read_g2o_switchable(ref_path)
    _assert_same(d_out, d_ref)
    assert sw_out.keys() == sw_ref.keys()
    for k in sw_ref:
        np.testing.assert_array_equal(sw_out[k], sw_ref[k])


def test_legacy_aliases_match_reference(tmp_path):
    path = tmp_path / "alias.g2o"
    path.write_text(
        "VERTEX_SE2 0 0 0 0\n"
        "VERTEX2 1 1 0 0.1\n"
        "VERTEX_SE2 2 2 0.1 0.2\n"
        "EDGE2 0 1 1 0 0.1 10 0 0 10 0 20\n"
        "EDGE_SE2 1 2 1 0.1 0.1 10 0 0 10 0 20\n"
        "FIX 0\n"
    )
    _assert_same(tg2o.read_g2o(path), jg2o.read_g2o(path))


@pytest.mark.parametrize("module", [jg2o, tg2o], ids=["reference", "port"])
def test_wrong_field_count_raises(module, tmp_path):
    path = tmp_path / "bad.g2o"
    path.write_text("VERTEX_SE2 0 0 0\n")
    with pytest.raises(ValueError, match="fields"):
        module.read_g2o(path)


_POSES = "VERTEX_SE2 0 0 0 0\nVERTEX_SE2 1 1 0 0\nVERTEX_SE2 2 2 0 0\nEDGE_SE2 0 1 1 0 0 1 0 0 1 0 1\nEDGE_SE2 1 2 1 0 0 1 0 0 1 0 1\n"


def test_switchable_vertex_id_out_of_range_raises(tmp_path):
    """Vertex id 7 on a 3-pose graph: the reference returns it as an edge
    index (the solver would then read out of bounds); the port refuses the
    file."""
    path = tmp_path / "sw.g2o"
    path.write_text(
        _POSES
        + "VERTEX_SWITCH 3 1\nEDGE_SWITCH_PRIOR 3 1 9\n"
        + "EDGE_SE2_SWITCHABLE 0 7 3 2 0 0 1 0 0 1 0 1\n"
    )
    data, _ = jg2o.read_g2o_switchable(path)
    assert max(data.edges_i.max(), data.edges_j.max()) == 7
    with pytest.raises(ValueError, match="vertex id 7 outside"):
        tg2o.read_g2o_switchable(path)
    # and the valid file the same edge makes within range reads as the reference's
    path.write_text(path.read_text().replace("EDGE_SE2_SWITCHABLE 0 7", "EDGE_SE2_SWITCHABLE 0 2"))
    (d_out, sw_out), (d_ref, sw_ref) = tg2o.read_g2o_switchable(path), jg2o.read_g2o_switchable(path)
    _assert_same(d_out, d_ref)
    for k in sw_ref:
        np.testing.assert_array_equal(sw_out[k], sw_ref[k])


def test_switchable_with_landmarks_raises(tmp_path):
    """A landmark file remaps its pose ids; raw switchable ids would index
    the wrong poses, so the port refuses the combination."""
    path = tmp_path / "sw_lm.g2o"
    path.write_text(
        _POSES
        + "VERTEX_XY 10 1 1\nEDGE_SE2_XY 0 10 1 1 1 0 1\n"
        + "EDGE_SE2_SWITCHABLE 0 2 3 2 0 0 1 0 0 1 0 1\n"
    )
    with pytest.raises(ValueError, match="landmark"):
        tg2o.read_g2o_switchable(path)
