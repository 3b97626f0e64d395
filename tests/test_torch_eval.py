"""The port's trajectory evaluation against the JAX reference in float64:
every ``TrajectoryMetrics`` number within 1e-12 for SE(2) and SE(3),
``.pkl`` and ``.mat`` files read across the two packages, ``associate``'s
index arrays identical (ties included), ``interpolate_poses``, the two
repairs of the reference's ``sync`` faults, and the plots under Agg."""

import numpy as np
import pytest
import torch

from pyslam_tpu.eval import TrajectoryMetrics as JaxMetrics
from pyslam_tpu.eval import TrajectoryVisualizer as JaxVisualizer
from pyslam_tpu.eval import associate as jax_associate
from pyslam_tpu.eval import interpolate_poses as jax_interpolate
from pyslam_tpu.lie import se2 as jse2
from pyslam_tpu.lie import se3 as jse3
from pyslam_tpu_torch.eval import TrajectoryMetrics, TrajectoryVisualizer, associate, interpolate_poses
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

TOL = 1e-12


def _close(out, ref, tol=TOL):
    out = out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


def _trajectories(dim, n=40, seed=0):
    """A winding ground truth and a drifting estimate (numpy, float64)."""
    rng = np.random.default_rng(seed)
    ops, dof = (jse2, 3) if dim == 2 else (jse3, 6)
    steps = np.asarray(ops.exp(rng.normal(0, 0.2, (n, dof)) + np.eye(dof)[0]))
    gt = [np.eye(dim + 1)]
    for S in steps[1:]:
        gt.append(gt[-1] @ S)
    gt = np.stack(gt)
    est = np.asarray(ops.exp(rng.normal(0, 0.05, (n, dof)))) @ gt
    return gt, est


@pytest.fixture(scope="module", params=[2, 3], ids=["se2", "se3"])
def pair(request):
    gt, est = _trajectories(request.param, seed=request.param)
    return JaxMetrics(gt, est), TrajectoryMetrics(gt, est, device="cpu")


SCALARS = ["endpoint_error", "mean_err", "rms_err", "cum_err", "armse"]


def test_paths_and_errors_match_reference(pair):
    ref, out = pair
    assert (out.dim, out.num_poses, out.convention) == (ref.dim, ref.num_poses, ref.convention)
    for name in ("positions_gt", "positions_est"):
        _close(getattr(out, name), getattr(ref, name))
    _close(out.cum_dists(), ref.cum_dists())
    _close(out.error(), ref.error())
    for kind in ("all", "trans", "rot"):
        for o, r in zip(*(x if kind == "all" else (x,) for x in (out.traj_errors(kind), ref.traj_errors(kind)))):
            _close(o, r)
    for delta in (1, 4):
        for o, r in zip(out.rel_errors("all", delta), ref.rel_errors("all", delta)):
            _close(o, r)


@pytest.mark.parametrize("name", SCALARS)
def test_summaries_match_reference(pair, name):
    ref, out = pair
    if name == "endpoint_error":
        _close(out.endpoint_error(), ref.endpoint_error())
        return
    for kind in ("trans", "rot"):
        _close(getattr(out, name)(kind), getattr(ref, name)(kind))
    for o, r in zip(getattr(out, name)("all"), getattr(ref, name)("all")):
        _close(o, r)


def test_alignment_matches_reference(pair):
    ref, out = pair
    methods = ("se2", "sim2") if out.dim == 2 else ("se3", "sim3")
    for method in methods + ("none",):
        a_ref, a_out = ref.align(method), out.align(method)
        _close(a_out.Twv_est, a_ref.Twv_est)
        _close(a_out.armse("trans"), a_ref.armse("trans"))
        if method != "none":
            for key in ("rotation", "translation", "scale"):
                _close(a_out.alignment[key], a_ref.alignment[key])
    with pytest.raises(ValueError):
        out.align("affine")


@pytest.mark.parametrize("unit", ["rad", "deg"])
def test_segment_errors_match_reference(pair, unit):
    ref, out = pair
    lengths = [2.0, 5.0, 11.0, 1e6]
    _close(out.segment_errors(lengths, unit), ref.segment_errors(lengths, unit))
    _close(out.mean_segment_errors(lengths, unit), ref.mean_segment_errors(lengths, unit))


def test_convention_and_shapes():
    gt, est = _trajectories(3)
    a = TrajectoryMetrics(np.linalg.inv(gt), np.linalg.inv(est), convention="Tvw", device="cpu")
    _close(a.error(), JaxMetrics(np.linalg.inv(gt), np.linalg.inv(est), convention="Tvw").error(), 1e-10)
    with pytest.raises(ValueError):
        TrajectoryMetrics(gt, est[:-1], device="cpu")
    with pytest.raises(ValueError):
        TrajectoryMetrics(gt, est, convention="Tww", device="cpu")
    # a list of tensors, and of float32 against float64, as the reference takes them
    b = TrajectoryMetrics(list(torch.from_numpy(gt)), est.astype(np.float32), device="cpu")
    assert b.Twv_gt.dtype == torch.float64


@pytest.mark.parametrize("ext", [".pkl", ".mat"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_files_load_across_packages(tmp_path, ext, writer):
    gt, est = _trajectories(3, n=12, seed=5)
    path = str(tmp_path / f"traj{ext}")
    if writer == "port":
        TrajectoryMetrics(gt, est, device="cpu").saveas(path)
        loaded = JaxMetrics.loadfrom(path)
        again = TrajectoryMetrics.loadfrom(path, device="cpu")
    else:
        JaxMetrics(gt, est).saveas(path)
        loaded = TrajectoryMetrics.loadfrom(path, device="cpu")
        again = JaxMetrics.loadfrom(path)
    for tm in (loaded, again):
        np.testing.assert_array_equal(np.asarray(tm.Twv_gt.cpu() if torch.is_tensor(tm.Twv_gt) else tm.Twv_gt), gt)
        np.testing.assert_array_equal(np.asarray(tm.Twv_est.cpu() if torch.is_tensor(tm.Twv_est) else tm.Twv_est), est)


# ---- sync ----


@pytest.mark.parametrize("seed", range(4))
def test_associate_matches_reference_ties_included(seed):
    """Stamps on a 5 ms grid, so that many gaps tie exactly; the reference's
    tuple order (gap, reference index, estimate index) decides them."""
    rng = np.random.default_rng(seed)
    t_ref = np.round(np.sort(rng.uniform(0, 2, 60)) / 0.005) * 0.005
    t_est = np.round(rng.uniform(0, 2, 45) / 0.005) * 0.005  # unsorted, duplicates
    for max_dt, offset in ((0.02, 0.0), (0.011, 0.005), (0.0, 0.0)):
        i_out, j_out = associate(t_ref, t_est, max_dt, offset)
        i_ref, j_ref = jax_associate(t_ref, t_est, max_dt, offset)
        assert i_out.dtype == np.int64 and j_out.dtype == np.int64
        np.testing.assert_array_equal(i_out, i_ref)
        np.testing.assert_array_equal(j_out, j_ref)


def test_associate_on_empty_and_disjoint_stamps():
    for t_ref, t_est in (([], [0.1]), ([0.0, 1.0], [5.0]), ([0.5], [])):
        i, j = associate(t_ref, t_est)
        i_ref, j_ref = jax_associate(t_ref, t_est)
        assert len(i) == len(j) == len(i_ref) == len(j_ref) == 0


def _stamped(n=20, seed=0):
    rng = np.random.default_rng(seed)
    T = np.asarray(jse3.exp(rng.normal(0, 0.4, (n, 6))))
    t = np.cumsum(rng.uniform(0.05, 0.2, n))
    return T, t


def test_interpolate_poses_matches_reference():
    T, t = _stamped()
    tq = np.concatenate([t[[0, 5, -1]], np.random.default_rng(1).uniform(t[0], t[-1], 30)])
    _close(interpolate_poses(T, t, tq, device="cpu"), jax_interpolate(T, t, tq))
    tq_out = np.array([t[0] - 1.0, t[-1] + 1.0, t[3]])
    with pytest.raises(ValueError, match="outside"):
        interpolate_poses(T, t, tq_out, device="cpu")
    _close(interpolate_poses(T, t, tq_out, extrapolate=True, device="cpu"),
           jax_interpolate(T, t, tq_out, extrapolate=True))


@pytest.mark.parametrize("fault", ["unsorted", "repeated"])
def test_interpolate_poses_refuses_unordered_stamps(fault):
    """The repair: the reference interpolates between the wrong poses on
    stamps that are not strictly increasing and says nothing; the port
    raises."""
    T, t = _stamped()
    t = t.copy()
    if fault == "unsorted":
        t[[4, 5]] = t[[5, 4]]
    else:
        t[7] = t[6]
    tq = np.array([t[3], t[6] + 1e-3, t[10]])
    jax_interpolate(T, t, tq)  # the reference returns poses
    with pytest.raises(ValueError, match="strictly increasing"):
        interpolate_poses(T, t, tq, device="cpu")


# ---- plots ----


def test_plots_render_the_references_data(tmp_path):
    gt, est = _trajectories(3, n=30, seed=2)
    ref = JaxVisualizer({"a": JaxMetrics(gt, est)})
    out = TrajectoryVisualizer(TrajectoryMetrics(gt, est, device="cpu"))
    assert list(out.tm_dict) == ["est"]
    out = TrajectoryVisualizer({"a": TrajectoryMetrics(gt, est, device="cpu")})
    import matplotlib.pyplot as plt

    for name, args in (("plot_topdown", ("xz",)), ("plot_segment_errors", ([1.0, 3.0],)), ("plot_norm_err", ()),
                       ("plot_cum_norm_err", ())):
        fig_o, ax_o = getattr(out, name)(*args)
        fig_r, ax_r = getattr(ref, name)(*args)
        for a, b in zip(np.atleast_1d(ax_o), np.atleast_1d(ax_r)):
            assert len(a.lines) == len(b.lines)
            for lo, lr in zip(a.lines, b.lines):
                np.testing.assert_allclose(lo.get_xydata(), lr.get_xydata(), rtol=0, atol=1e-10)
        plt.close(fig_o)
        plt.close(fig_r)
    path = tmp_path / "topdown.png"
    out.plot_topdown(outfile=str(path))
    assert path.stat().st_size > 0
