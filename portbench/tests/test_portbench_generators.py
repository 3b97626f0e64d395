"""The generators made on the device from the seed: counts and shapes that
follow their formulas, the same seed the same problem, large seeds."""

import json

import numpy as np
import pytest
import torch
from conftest import ROOT

from portbench.generators import bal_scene, se3_sphere


def _sizes(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())["sizes"]


@pytest.mark.parametrize("n", [1, 12, 51, 60, 400, 2500])
def test_sphere_counts(n):
    p = se3_sphere.generate(dict(_sizes("sphere30k"), n_poses=n), 3, "cpu")
    c = se3_sphere.counts(p)
    assert c["odometry"] == n - 1 and 0 <= c["loops"] <= max(0, n - 51)
    assert c["edges"] == p["edges_j"].shape[0] == p["T_meas"].shape[0] == p["sqrt_info"].shape[0]
    assert p["poses_init"].shape == p["poses_gt"].shape == (n, 4, 4)
    i, j = p["edges_i"], p["edges_j"]
    assert bool((i < j).all()) and bool((j < n).all())
    assert bool((j[n - 1:] - i[n - 1:] > 10).all())  # loop partners more than 10 poses apart
    assert len({(a, b) for a, b in zip(i.tolist(), j.tolist())}) == c["edges"]


def test_sphere_at_the_cell_size_has_sphere2500s_density():
    c = se3_sphere.counts(se3_sphere.generate(_sizes("sphere30k"), 2**31 + 7, "cpu"))
    assert c == dict(poses=30000, edges=59948, odometry=29999, loops=29949)


def test_sphere_start_is_the_integrated_odometry():
    p = se3_sphere.generate(dict(_sizes("sphere30k"), n_poses=200), 5, "cpu")
    T = [p["poses_gt"][0]]
    for k in range(199):
        T.append(p["T_meas"][k] @ T[-1])
    T = torch.stack(T)
    assert torch.allclose(p["poses_init"][:, :3, 3], T[:, :3, 3], atol=1e-9)
    R = p["poses_init"][:, :3, :3]
    assert torch.allclose(R @ R.transpose(1, 2), torch.eye(3, dtype=R.dtype).expand_as(R), atol=1e-12)


@pytest.mark.parametrize("pts,obs,longest", [(993923, 5001946, 1778), (1500, 6000, 12), (1000, 2000, 5),
                                             (1000, 5000, 5), (700, 3333, 30)])
def test_track_lengths_add_up(pts, obs, longest):
    c = bal_scene.track_counts(pts, obs, longest)
    k = np.arange(2, longest + 1)
    assert c.shape == (longest - 1,) and bool((c >= 0).all())
    assert int(c.sum()) == pts and int(c @ k) == obs


def test_track_lengths_at_venice_are_skewed():
    c = bal_scene.track_counts(993923, 5001946, 1778)
    lengths = np.repeat(np.arange(2, 1779), c)
    assert np.median(lengths) <= 3 and lengths.max() > 1000  # most points seen twice or thrice, a long tail


@pytest.mark.parametrize("cams,pts,obs", [(12, 1500, 6000), (30, 4000, 20000), (3, 100, 250)])
def test_ba_counts(cams, pts, obs):
    sizes = dict(_sizes("venice_ba"), n_cams=cams, n_pts=pts, n_obs=obs)
    p = bal_scene.generate(sizes, 9, "cpu")
    assert bal_scene.counts(p) == dict(cameras=cams, points=pts, observations=obs)
    per_point = torch.bincount(p["pt_idx"], minlength=pts)
    expected = bal_scene.track_counts(pts, obs, cams)
    assert torch.equal(torch.bincount(per_point, minlength=cams + 1)[2:], torch.as_tensor(expected))
    assert bool((p["cam_idx"] >= 0).all() and (p["cam_idx"] < cams).all())
    pairs = p["cam_idx"] * pts + p["pt_idx"]
    assert pairs.unique().numel() == pairs.numel()  # a camera sees a point once
    assert bool((p["pt_idx"][1:] >= p["pt_idx"][:-1]).all())  # by point
    T = p["poses_gt"][p["cam_idx"]]
    pc = (T[:, :3, :3] @ p["pts_gt"][p["pt_idx"]][..., None])[..., 0] + T[:, :3, 3]
    pn = -pc[:, :2] / pc[:, 2:]
    assert bool((pc[:, 2] < -1).all()) and bool((pn.abs() <= 1).all())  # in front, inside the field
    assert p["obs"].shape == (obs, 2) and p["intrinsics"].shape == (cams, 3)
    assert torch.equal(p["poses_init"][0], p["poses_gt"][0])


def test_every_seed_has_the_same_track_lengths():
    sizes = dict(_sizes("venice_ba"), n_cams=20, n_pts=2000, n_obs=9000)
    hist = [torch.bincount(torch.bincount(bal_scene.generate(sizes, s, "cpu")["pt_idx"])) for s in (1, 2**33 + 1)]
    assert torch.equal(hist[0], hist[1])


@pytest.mark.parametrize("gen,name,small", [
    (bal_scene, "venice_ba", dict(n_cams=12, n_pts=500, n_obs=2000)),
    (se3_sphere, "sphere30k", dict(n_poses=300)),
])
@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 2**40 + 3])
def test_the_seed_decides_the_problem(gen, name, small, seed):
    sizes = dict(_sizes(name), **small)
    a, b, c = gen.generate(sizes, seed, "cpu"), gen.generate(sizes, seed, "cpu"), gen.generate(sizes, seed + 1, "cpu")
    for key, value in a.items():
        if torch.is_tensor(value):
            assert torch.equal(value, b[key]), key
    assert not torch.equal(a["poses_init"], c["poses_init"])
