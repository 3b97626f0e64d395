"""The partitioner of the torch port (``pyslam_tpu_torch/dist/partitioner.py``,
a copy of the reference's numpy module) against the reference's: the same
arrays, bit for bit, on the reference's own cases and on random graphs;
and the parts of ``dist/mesh.py`` that need no process group."""

import numpy as np
import pytest
import torch

import pyslam_tpu.dist.partitioner as jp
import pyslam_tpu_torch.dist.partitioner as tp
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu_torch import dist
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)


def _same(a, b):
    assert type(a).__name__ == type(b).__name__
    np.testing.assert_array_equal(a.part, b.part)
    assert a.part.dtype == b.part.dtype and a.n_parts == b.n_parts
    np.testing.assert_array_equal(a.counts(), b.counts())


def test_bfs_chain_cuts_n_parts_minus_one_edges():
    n = 64
    ei, ej = np.arange(n - 1), np.arange(1, n)
    part = tp.partition_poses_bfs(ei, ej, n, 4)
    stats = tp.cut_stats(ei, ej, part)
    assert stats == jp.cut_stats(ei, ej, jp.partition_poses_bfs(ei, ej, n, 4))
    assert stats["edge_cut"] == 3 and sorted(stats["counts"]) == [16] * 4 and stats["imbalance"] <= 1.01


@pytest.mark.parametrize("n_parts", [1, 2, 3, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_bfs_on_loops_matches_reference(n_parts, seed):
    data = jsynth.se2_loop(n_poses=50, n_loops=6, seed=seed)
    ei, ej = np.asarray(data.edges_i), np.asarray(data.edges_j)
    ours, ref = tp.partition_poses_bfs(ei, ej, 50, n_parts), jp.partition_poses_bfs(ei, ej, 50, n_parts)
    _same(ours, ref)
    assert ((ours.part >= 0) & (ours.part < n_parts)).all()
    assert tp.cut_stats(ei, ej, ours) == jp.cut_stats(ei, ej, ref)


@pytest.mark.parametrize("seed", range(4))
def test_random_graphs_match_reference(seed):
    """Disconnected random graphs (several BFS seeds), landmarks by
    plurality of a camera partition (unobserved ones round-robin) and
    balanced contiguous blocks."""
    rng = np.random.default_rng(seed)
    n, parts = int(rng.integers(10, 80)), int(rng.integers(2, 6))
    ei, ej = rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)
    _same(tp.partition_poses_bfs(ei, ej, n, parts), jp.partition_poses_bfs(ei, ej, n, parts))
    L = int(rng.integers(5, 60))
    cam_idx, pt_idx = rng.integers(0, n, 3 * L), rng.integers(0, L - 2, 3 * L)
    cam_part = rng.integers(0, parts, n)
    _same(tp.partition_landmarks(cam_idx, pt_idx, L, cam_part=tp.Partition(cam_part, parts)),
          jp.partition_landmarks(cam_idx, pt_idx, L, cam_part=jp.Partition(cam_part, parts)))
    _same(tp.partition_landmarks(None, None, L, n_parts=parts), jp.partition_landmarks(None, None, L, n_parts=parts))


def test_landmark_plurality():
    cam_part = tp.Partition(np.array([0, 0, 1, 1]), 2)
    part = tp.partition_landmarks(np.array([0, 1, 2, 0, 2, 3]), np.array([0, 0, 0, 1, 1, 1]), 3, cam_part=cam_part)
    assert part.part[0] == 0 and 0 <= part.part[2] < 2


def test_contiguous_default_is_balanced():
    c = tp.partition_landmarks(None, None, 103, n_parts=8).counts()
    assert c.sum() == 103 and c.max() - c.min() <= 1


def test_make_mesh_needs_a_process_group():
    """No silent world of one: without ``init_distributed`` the mesh
    raises, and the collectives' counters start at 0."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        dist.make_mesh(device="cpu")
    dist.reset_collectives()
    assert dist.COLLECTIVES == {"psum": 0, "all_gather": 0}
