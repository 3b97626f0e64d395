"""The pieces of the ``bal_final13682`` configuration: its generator's counts
and its tracks' parallax, and the ``bal_rows_roofline`` reader's count."""

import json
import math

import numpy as np
import pytest
import torch
from conftest import ROOT

from portbench import harness, roofline
from portbench.generators import bal_scene, bal_scene9
from portbench.metrics import bal_rows_roofline

CONFIG = json.loads((ROOT / "portbench" / "configs" / "bal_final13682.json").read_text())


def test_final_track_lengths_add_up_exactly():
    """BAL Final's counts: 4,456,117 points and 28,987,644 observations on
    tracks of 2 to 13,682 cameras."""
    s, source = CONFIG["sizes"], CONFIG["source_sizes"]
    counts = ("n_cams", "n_pts", "n_obs")
    assert tuple(s[k] for k in counts) == tuple(source[k] for k in counts) == (13682, 4456117, 28987644)
    c = bal_scene.track_counts(s["n_pts"], s["n_obs"], s["n_cams"])
    k = np.arange(2, s["n_cams"] + 1)
    assert int(c.sum()) == s["n_pts"] and int(c @ k) == s["n_obs"]


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_every_track_has_its_parallax_and_the_counts_are_kept(seed):
    """On 2,000 cameras: the draw has tracks below 2 degrees of parallax,
    and none is left; the counts, the points and the observations of every
    camera not moved are ``bal_scene``'s; a moved observation is the
    truth's projection within the pixel noise, in front of its camera."""
    sizes = dict(CONFIG["sizes"], n_cams=2000, n_pts=20000, n_obs=120000)
    plain = bal_scene.generate(sizes, seed, "cpu")
    p = bal_scene9.generate(sizes, seed, "cpu")
    assert bal_scene9.counts(p) == bal_scene.counts(plain) == dict(cameras=2000, points=20000, observations=120000)
    assert torch.equal(p["pt_idx"], plain["pt_idx"])
    threshold = 1 - math.cos(math.radians(sizes["min_parallax_deg"]))
    assert int(bal_scene9._failing(plain, plain["cam_idx"], threshold).sum()) > 0
    assert not bal_scene9._failing(p, p["cam_idx"], threshold).any()
    kept = p["cam_idx"] == plain["cam_idx"]
    assert torch.equal(p["obs"][kept], plain["obs"][kept]) and 0 < int((~kept).sum()) < 0.01 * 120000
    moved = torch.nonzero(~kept).flatten()
    T, K = p["poses_gt"][p["cam_idx"][moved]], p["intrinsics"][p["cam_idx"][moved]]
    pc = (T[:, :3, :3] @ p["pts_gt"][p["pt_idx"][moved]][..., None])[..., 0] + T[:, :3, 3]
    pn = -pc[:, :2] / pc[:, 2:]
    r2 = (pn * pn).sum(-1)
    pred = (K[:, 0] * (1 + r2 * (K[:, 1] + K[:, 2] * r2)))[:, None] * pn
    assert bool((pc[:, 2] < 0).all()) and float((p["obs"][moved] - pred).abs().max()) < 6 * sizes["pixel_std"]


def test_the_parallax_test_reads_two_rays_by_their_angle():
    """Two cameras whose rays to a point meet at 1 or 179 degrees fail; at
    3 they pass; a track that sees one camera twice fails."""
    rot = torch.eye(4, dtype=torch.float64).expand(4, 4, 4).clone()

    def camera_at(deg):  # a camera centre 10 from the point at the origin, at an angle in the x-y plane
        a = math.radians(deg)
        return -torch.tensor([10 * math.cos(a), 10 * math.sin(a), 0.0], dtype=torch.float64)

    for k, deg in enumerate((0.0, 1.0, 3.0, 179.0)):
        rot[k, :3, 3] = camera_at(deg)  # R = I: t = -centre
    problem = dict(poses_gt=rot, pts_gt=torch.zeros(4, 3, dtype=torch.float64),
                   pt_idx=torch.tensor([0, 0, 1, 1, 2, 2, 3, 3]))
    cam = torch.tensor([0, 1, 0, 2, 0, 3, 2, 2])
    threshold = 1 - math.cos(math.radians(2.0))
    assert bal_scene9._failing(problem, cam, threshold).tolist() == [True, False, True, True]


def test_the_same_seed_gives_the_same_problem():
    sizes = dict(CONFIG["sizes"], **CONFIG["test_sizes"])
    a, b = bal_scene9.generate(sizes, 2**31 + 9, "cpu"), bal_scene9.generate(sizes, 2**31 + 9, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_the_roofline_count_reads_the_calls_own_tensors():
    """A 9-dof call's bytes: every input tensor once, the rows at 90 wide and
    the cost; a 6-dof call and a call with no launch give no record."""
    M, C, L = 1000, 7, 300
    f32 = dict(dtype=torch.float32)
    idx = torch.zeros(M, dtype=torch.int64)
    common = (torch.zeros(L, 3, **f32), idx, idx, torch.zeros(M, 2, **f32))
    tail = (torch.eye(2, **f32), torch.ones(M, **f32))
    nine = bal_rows_roofline.count((torch.zeros(C, 19, **f32), *common, None, None, None, *tail, None), {},
                                   (torch.zeros(M, **f32), torch.zeros(M, 90, **f32)))
    inputs = 4 * (C * 19 + L * 3 + 2 * M + 4 + M) + 16 * M
    assert nine == dict(bytes=inputs + 4 * M * 91, flop=600 * M, dtype="float32")
    cost_only = bal_rows_roofline.count((torch.zeros(C, 19, **f32), *common, None, None, None, *tail, None), {},
                                        (torch.zeros(M, **f32), None))
    assert cost_only["bytes"] == inputs + 4 * M and cost_only["flop"] == 60 * M
    six = bal_rows_roofline.count((torch.zeros(C, 4, 4, **f32), *common, *(torch.ones(M, **f32),) * 3, *tail, None),
                                  {}, (torch.zeros(M, **f32), torch.zeros(M, 54, **f32)))
    assert six is None
    empty = torch.zeros(0, dtype=torch.int64)
    assert bal_rows_roofline.count((torch.zeros(C, 19, **f32), common[0], empty, empty), {}, (None, None)) is None
    assert bal_rows_roofline._bound(nine) == roofline.bound_s(nine["bytes"], nine["flop"]) > 0


def test_the_reader_gives_nothing_where_no_9_dof_launch_ran():
    run = harness.Run({}, {}, {}, 1)
    assert bal_rows_roofline.read(run) is None


def test_the_least_eigenvalue_in_closed_form():
    g = torch.Generator().manual_seed(0)
    X = torch.randn(5000, 3, 3, generator=g, dtype=torch.float64)
    A = X @ X.transpose(1, 2)
    A[0] = 2 * torch.eye(3, dtype=torch.float64)  # a repeated eigenvalue
    A[1] = torch.diag(torch.tensor([1.0, 1.0, 1e-9], dtype=torch.float64))
    ref = torch.linalg.eigvalsh(A)[:, 0]
    assert float((bal_scene9._least_eigenvalue(A) - ref).abs().max()) < 1e-10
