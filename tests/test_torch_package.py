"""Boundaries of the torch port: it imports neither JAX nor the JAX
package, sets the full-f32 matmul flags, builds on the CUDA device unless
the caller asks for the CPU, and its chip smoke script fails cleanly where
there is no GPU."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import pyslam_tpu_torch
from pyslam_tpu_torch import imu
from pyslam_tpu_torch.graph import build, convert, initialize, marginalize
from pyslam_tpu_torch.io import bal, synth
from pyslam_tpu_torch.lie import se2, se3, sim3, so2, so3
from pyslam_tpu_torch.pipelines import stereo_match
from pyslam_tpu_torch.solver import FixedLagLandmarkSmoother, FixedLagSmoother, IncrementalSmoother, covariance
from pyslam_tpu_torch.testing import se3_stress_graph
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "pyslam_tpu_torch"
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|pyslam_tpu)\b", re.M)


# A subprocess here takes about 3 s (an import of torch and the package):
# a hang fails its test after SUBPROCESS_TIMEOUT_S, and a slow host has room.
SUBPROCESS_TIMEOUT_S = 15


def _run(code, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=SUBPROCESS_TIMEOUT_S,
    )


def test_import_leaves_jax_out():
    proc = _run(
        "import sys, pyslam_tpu_torch\n"
        "import pyslam_tpu_torch.solver.cuda_ops, pyslam_tpu_torch._ext\n"
        "import pyslam_tpu_torch.sensors, pyslam_tpu_torch.io.bal, pyslam_tpu_torch.solver.schur\n"
        "import pyslam_tpu_torch.graph.build, pyslam_tpu_torch.graph.convert, pyslam_tpu_torch.graph.factor_defs\n"
        "import pyslam_tpu_torch.solver.plan_cache, pyslam_tpu_torch.solver.sparse_chol\n"
        "import pyslam_tpu_torch.solver.schur_sparse, pyslam_tpu_torch.solver.batched\n"
        "from pyslam_tpu_torch.solver import route_auto, solve_auto, solve_batched, solve_sparse_chol\n"
        "from pyslam_tpu_torch.solver import build_chol_plan, sparse_chol_solve, solve_schur_sparse\n"
        "from pyslam_tpu_torch.solver import build_schur_sparse_plan\n"
        "import pyslam_tpu_torch.solver.host_loop, pyslam_tpu_torch.solver.schur_large\n"
        "from pyslam_tpu_torch.solver import host_lm_loop, solve_schur_large, prepare_large_ba\n"
        "import pyslam_tpu_torch.dist, pyslam_tpu_torch.dist.mesh, pyslam_tpu_torch.dist.partitioner\n"
        "import pyslam_tpu_torch.dist.factor_parallel, pyslam_tpu_torch.dist.schur_reduce\n"
        "import pyslam_tpu_torch.dist.pose_sharded, pyslam_tpu_torch.testing\n"
        "import pyslam_tpu_torch.dist.schur_cm\n"
        "from pyslam_tpu_torch.dist import solve_schur_cm, shard_ba_cm, make_cm_step, ShardedCM\n"
        "from pyslam_tpu_torch.solver import BlockPattern, build_pattern, assemble_bcsr, bcsr_matvec, solve_bcsr\n"
        "from pyslam_tpu_torch.solver.schur_large import build_cluster_pairs\n"
        "from pyslam_tpu_torch.dist import make_mesh, init_distributed, solve_schur_sharded, solve_pose_sharded\n"
        "import pyslam_tpu_torch.imu, pyslam_tpu_torch.io.euroc, pyslam_tpu_torch.io.trajectory\n"
        "import pyslam_tpu_torch.graph.initialize, pyslam_tpu_torch.solver.gnc\n"
        "from pyslam_tpu_torch.graph import chordal_init, spanning_tree_init\n"
        "from pyslam_tpu_torch.graph.build import switchable_pose_graph\n"
        "from pyslam_tpu_torch.solver import solve_gnc, GNCInfo\n"
        "from pyslam_tpu_torch.imu import preintegrate, sqrt_info_of, vio_graph, ImuParams, PreintegratedImu\n"
        "from pyslam_tpu_torch.io import euroc, trajectory\n"
        "import pyslam_tpu_torch.graph.marginalize, pyslam_tpu_torch.solver.fixed_lag\n"
        "import pyslam_tpu_torch.solver.incremental, pyslam_tpu_torch.solver.schur_sqrt\n"
        "from pyslam_tpu_torch.graph import marginalize\n"
        "from pyslam_tpu_torch.solver import FixedLagSmoother, FixedLagLandmarkSmoother, IncrementalSmoother\n"
        "from pyslam_tpu_torch.solver import solve_schur_sqrt, build_sqrt_plan, SqrtBAPlan\n"
        "import pyslam_tpu_torch.solver.covariance\n"
        "from pyslam_tpu_torch.solver import full_covariance, marginal_covariances, marginal_covariances_direct\n"
        "from pyslam_tpu_torch.solver import covariance_block, covariance_blocks_direct, pose_marginal_covariances\n"
        "from pyslam_tpu_torch.solver import pose_covariance_block, landmark_marginal_covariances\n"
        "from pyslam_tpu_torch.solver import landmark_covariance_block, pose_landmark_covariance_block\n"
        "from pyslam_tpu_torch.solver import selected_inverse_marginals, locate_fill_pairs, factor_logdet\n"
        "from pyslam_tpu_torch.dist import sharded_pose_marginals, sharded_landmark_marginals\n"
        "import pyslam_tpu_torch.problem, pyslam_tpu_torch.residuals, pyslam_tpu_torch.lie.groups\n"
        "import pyslam_tpu_torch.utils, pyslam_tpu_torch.debug, pyslam_tpu_torch.observability\n"
        "import pyslam_tpu_torch.solver.diff\n"
        "from pyslam_tpu_torch import Problem, Options, SE3, Sim3, QuadraticResidual, DensePriorResidual\n"
        "from pyslam_tpu_torch.solver import solve_implicit\n"
        "from pyslam_tpu_torch.graph import register_autodiff_factor, check_autodiff_factor, register_closed_kernel\n"
        "import pyslam_tpu_torch.pipelines, pyslam_tpu_torch.pipelines.dense, pyslam_tpu_torch.pipelines.keyframes\n"
        "import pyslam_tpu_torch.pipelines.photometric, pyslam_tpu_torch.pipelines.ransac\n"
        "import pyslam_tpu_torch.pipelines.stereo_match\n"
        "import pyslam_tpu_torch.eval, pyslam_tpu_torch.eval.metrics, pyslam_tpu_torch.eval.sync\n"
        "import pyslam_tpu_torch.eval.viz\n"
        "from pyslam_tpu_torch import eval, pipelines, TrajectoryMetrics, TrajectoryVisualizer\n"
        "from pyslam_tpu_torch.pipelines import DenseRGBDPipeline, DenseStereoPipeline, FrameToFrameRANSAC\n"
        "from pyslam_tpu_torch.pipelines import PhotometricResidualSE3, compute_disparity, DenseKeyframe\n"
        "from pyslam_tpu_torch.eval import associate, interpolate_poses\n"
        "import pyslam_tpu_torch.native\n"
        "from pyslam_tpu_torch.native import available, count_tokens, parse_doubles, scan_tagged\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pyslam_tpu'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok')"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", ["package", "chip_smoke.py", "profile_port.py"])
def test_sources_do_not_import_jax(path):
    files = sorted(PKG.rglob("*.py")) if path == "package" else [ROOT / path]
    assert files
    offenders = [str(f.relative_to(ROOT)) for f in files if _IMPORT.search(f.read_text())]
    assert not offenders


_BLOCK = dict(kind="se2", values=np.eye(3)[None], const_mask=np.zeros(1, bool))


def _mesh_entry(**kw):
    """``make_mesh`` in a world of one rank (gloo, over a file store):
    one psum of a tensor on the mesh's device, which it returns."""
    import tempfile

    from pyslam_tpu_torch import dist

    with tempfile.TemporaryDirectory() as store:
        dist.init_distributed(f"file://{store}/store", 1, 0, backend="gloo", device="cpu")
        try:
            mesh = dist.make_mesh(**kw)
            return mesh.psum(torch.zeros(1, device=mesh.device))
        finally:
            torch.distributed.destroy_process_group()


_IMU = synth.imu_circle(n_keyframes=3, kf_dt=0.1, imu_rate=50, seed=0)


def _chordal_entry(**kw):
    """``chordal_init``'s stages on the given device: it returns host poses,
    so the device its stage graphs were built on is read by wrapping the
    stage solver."""
    seen = []
    solve_stage = initialize._solve_stage

    def record(g, *args):
        seen.append(next(iter(g.blocks.values())).values.device)
        return solve_stage(g, *args)

    data = synth.se3_sphere(n_poses=8, seed=0)
    initialize._solve_stage = record
    try:
        T0 = initialize.chordal_init(data.edges_i, data.edges_j, data.T_meas, 8, **kw)
    finally:
        initialize._solve_stage = solve_stage
    assert T0.shape == (8, 4, 4) and len(seen) == 2 and seen[0] == seen[1]
    return torch.zeros(0, device=seen[0])


def _LOOP(**kw):
    return build.pose_graph(synth.se2_loop(n_poses=6, n_loops=1, seed=0), dtype=torch.float64, **kw)


def _BA(**kw):
    return build.ba_graph(synth.ba_synthetic(n_cams=3, n_pts=8, seed=0), dtype=torch.float64, **kw)


def _problem_graph(**kw):
    """The graph a Problem of one SE(2) prior builds."""
    problem = pyslam_tpu_torch.Problem(**kw)
    problem.add_residual_block(pyslam_tpu_torch.PoseResidual(np.eye(3), 1.0), ["T"])
    problem.initialize_params({"T": pyslam_tpu_torch.SE2(np.eye(3))})
    return problem._build()


_PLANE = dict(cu=15.5, cv=11.5, fu=50.0, fv=50.0, w=32, h=24)
_IM = np.random.default_rng(0).uniform(0.2, 0.8, (24, 32))


def _pipeline(stereo, **kw):
    """A pipeline's keyframe level, after its first frame."""
    from pyslam_tpu_torch import pipelines, sensors

    if stereo:
        pipe = pipelines.DenseStereoPipeline(sensors.StereoCamera(b=0.3, **_PLANE), pyrlevels=2, **kw)
        pipe.track(_IM, _IM, disp=np.full((24, 32), 4.0))
    else:
        pipe = pipelines.DenseRGBDPipeline(sensors.RGBDCamera(**_PLANE), pyrlevels=2, **kw)
        pipe.track(_IM, np.full((24, 32), 3.0))
    return pipe.keyframes[0].levels[1].pt_ref


def _ransac(**kw):
    from pyslam_tpu_torch import pipelines, sensors

    cam = sensors.StereoCamera(b=0.3, **_PLANE)
    obs = np.stack([np.linspace(2, 28, 20), np.linspace(2, 20, 20), np.linspace(3, 8, 20)], axis=-1)
    return pipelines.FrameToFrameRANSAC(cam, num_iters=8, polish=False, **kw).compute_transform(obs, obs)[0].mat


DEFAULT_DEVICE_ENTRY_POINTS = {
    "default_device": pyslam_tpu_torch.default_device,
    "pose_graph": lambda **kw: build.pose_graph(synth.se2_loop(n_poses=6, n_loops=1, seed=0), **kw),
    "sim3_pose_graph": lambda **kw: build.sim3_pose_graph(synth.sim3_loop(n_poses=6, n_loops=1, seed=0), **kw),
    "ba_graph": lambda **kw: build.ba_graph(synth.ba_synthetic(n_cams=3, n_pts=8, seed=0), **kw),
    "bal_graph": lambda **kw: build.bal_graph(bal.synthetic_bal(n_cams=3, n_pts=8, seed=0), **kw),
    "bal_graph_intrinsics": lambda **kw: build.bal_graph(
        bal.synthetic_bal(n_cams=3, n_pts=8, seed=0), optimize_intrinsics=True, **kw),
    "landmark_slam_2d": lambda **kw: build.landmark_slam_2d(
        synth.landmark_slam_2d(n_poses=6, n_landmarks=4, seed=0), **kw),
    "graph_from_numpy": lambda **kw: convert.graph_from_numpy({"poses": _BLOCK}, [], torch.float64, **kw),
    "se3_stress_graph": lambda **kw: se3_stress_graph(n_poses=24, **kw),
    "make_mesh": _mesh_entry,
    "pose_graph_chordal": lambda **kw: build.pose_graph(synth.se2_loop(n_poses=6, n_loops=1, seed=0), init="chordal",
                                                        **kw),
    "pose_graph_spanning_tree": lambda **kw: build.pose_graph(synth.se3_sphere(n_poses=8, seed=0),
                                                              init="spanning_tree", **kw),
    "chordal_init": lambda **kw: _chordal_entry(**kw),
    "switchable_pose_graph": lambda **kw: build.switchable_pose_graph(synth.se2_loop(n_poses=8, n_loops=2, seed=0),
                                                                      **kw),
    "vio_graph": lambda **kw: imu.vio_graph(_IMU, _IMU.T_gt, np.eye(6), **kw),
    "preintegrate": lambda **kw: imu.preintegrate(_IMU.omega[0], _IMU.accel[0], _IMU.dts[0], np.zeros(3), np.zeros(3),
                                                  **kw).dR,
    "marginalize": lambda **kw: marginalize(build.pose_graph(synth.se2_loop(n_poses=6, n_loops=1, seed=0), **kw),
                                            {"poses": [2, 3]}),
    "FixedLagSmoother": lambda **kw: FixedLagSmoother(window=4, kind="se2", **kw).T,
    "FixedLagLandmarkSmoother": lambda **kw: FixedLagLandmarkSmoother(window=4, lm_slots=3,
                                                                      obs_kind="landmark_xy_se2", kind="se2", **kw).Hp,
    "IncrementalSmoother": lambda **kw: IncrementalSmoother(kind="se2", **kw)._graph(),
    # the covariance queries answer on the device of the graph they are given
    "full_covariance": lambda **kw: covariance.full_covariance(_LOOP(**kw)),
    "marginal_covariances": lambda **kw: covariance.marginal_covariances(_LOOP(**kw), indices=[1, 2]),
    "marginal_covariances_direct": lambda **kw: covariance.marginal_covariances_direct(_LOOP(**kw)),
    "pose_marginal_covariances": lambda **kw: covariance.pose_marginal_covariances(_BA(**kw), indices=[1]),
    "landmark_marginal_covariances": lambda **kw: covariance.landmark_marginal_covariances(_BA(**kw), [0, 3]),
    "Problem": lambda **kw: _problem_graph(**kw).blocks["se2_3x3"].values,
    "SE3.identity": lambda **kw: pyslam_tpu_torch.SE3.identity(**kw).mat,
    "DenseRGBDKeyframe": lambda **kw: pyslam_tpu_torch.pipelines.DenseRGBDKeyframe(
        _IM, np.full((24, 32), 3.0), pyslam_tpu_torch.RGBDCamera(**_PLANE), pyrlevels=2, **kw).levels[0].pt_ref,
    "DenseStereoKeyframe": lambda **kw: pyslam_tpu_torch.pipelines.DenseStereoKeyframe(
        _IM, _IM, pyslam_tpu_torch.StereoCamera(b=0.3, **_PLANE), pyrlevels=2, disp=np.full((24, 32), 4.0),
        **kw).levels[1].mask,
    "DenseRGBDPipeline": lambda **kw: _pipeline(False, **kw),
    "DenseStereoPipeline": lambda **kw: _pipeline(True, **kw),
    "block_match": lambda **kw: stereo_match.block_match(_IM, _IM, num_disparities=16, **kw),
    "FrameToFrameRANSAC": _ransac,
    "TrajectoryMetrics": lambda **kw: pyslam_tpu_torch.TrajectoryMetrics(np.eye(4)[None], np.eye(4)[None],
                                                                         **kw).Twv_est,
    "so2.identity": so2.identity,
    "se2.identity": se2.identity,
    "so3.identity": so3.identity,
    "se3.identity": se3.identity,
    "sim3.identity": sim3.identity,
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_ENTRY_POINTS))
def test_entry_points_default_to_the_cuda_device(name):
    """With no device given an entry point builds on the card; where there
    is none it raises, and the message says how to ask for the CPU.  It
    never falls back to the CPU by itself."""
    fn = DEFAULT_DEVICE_ENTRY_POINTS[name]
    if torch.cuda.is_available():
        out = fn()
        device = out if isinstance(out, torch.device) else (
            out.device if torch.is_tensor(out) else out.blocks["poses"].values.device)
        assert device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn()
    if name != "default_device":
        out = fn(device="cpu")
        tensors = [out] if torch.is_tensor(out) else [
            t for b in out.blocks.values() for t in (b.values, b.const_mask)] + [
            t for fb in out.batches for t in (*fb.indices, fb.weight, *fb.data.values()) if torch.is_tensor(t)]
        assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_chip_smoke_fails_without_a_gpu():
    """Here (no CUDA device) the smoke script exits non-zero and prints no
    result line."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S,
    )
    if proc.returncode == 0:
        pytest.skip("a CUDA device is present: the script ran for real")
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr or "cuda" in proc.stderr.lower()
