"""Factor-graph partitioning for the variable-sharded solvers.

A copy of ``pyslam_tpu/dist/partitioner.py``: the functions are numpy
only, so they are carried over unchanged and give the same arrays
(``tests/test_torch_partitioner.py``).  No METIS here either, so partition
quality comes from cheap structure-aware heuristics:

  * ``partition_poses_bfs``   — greedy BFS growth over the pose graph:
    contiguous, low-cut parts for trajectory-like graphs.
  * ``partition_landmarks``   — landmarks assigned to the part owning the
    plurality of their observations, or balanced contiguous blocks.
  * ``cut_stats``             — edge cut + balance diagnostics.

All host-side numpy, run once per solve on every rank with the same
result, so every rank knows every rank's share.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Partition:
    """part[i] = owning part of variable i; parts are 0..n_parts-1."""

    part: np.ndarray
    n_parts: int

    def counts(self) -> np.ndarray:
        return np.bincount(self.part, minlength=self.n_parts)


def partition_poses_bfs(edges_i, edges_j, n_poses: int, n_parts: int) -> Partition:
    """Greedy BFS partition: grow each part to ~n/n_parts poses by BFS from
    the lowest-index unassigned pose.  For chain/loop pose graphs this gives
    contiguous segments with O(n_parts) cut edges."""
    edges_i = np.asarray(edges_i)
    edges_j = np.asarray(edges_j)
    adj_head = np.full(n_poses, -1, np.int64)
    adj_next = np.full(2 * len(edges_i), -1, np.int64)
    adj_to = np.empty(2 * len(edges_i), np.int64)
    for k, (a, b) in enumerate(zip(edges_i, edges_j)):
        for slot, (u, v) in enumerate(((a, b), (b, a))):
            e = 2 * k + slot
            adj_to[e] = v
            adj_next[e] = adj_head[u]
            adj_head[u] = e

    part = np.full(n_poses, -1, np.int64)
    target = (n_poses + n_parts - 1) // n_parts
    cur_part, cur_size = 0, 0
    from collections import deque

    queue: deque = deque()
    next_seed = 0
    while True:
        if not queue:
            while next_seed < n_poses and part[next_seed] != -1:
                next_seed += 1
            if next_seed >= n_poses:
                break
            queue.append(next_seed)
        u = queue.popleft()
        if part[u] != -1:
            continue
        if cur_size >= target and cur_part < n_parts - 1:
            cur_part += 1
            cur_size = 0
            queue.clear()
            queue.append(u)
            continue
        part[u] = cur_part
        cur_size += 1
        e = adj_head[u]
        while e != -1:
            v = adj_to[e]
            if part[v] == -1:
                queue.append(v)
            e = adj_next[e]
    return Partition(part, n_parts)


def partition_landmarks(
    cam_idx, pt_idx, n_landmarks: int, cam_part: Partition | None = None,
    n_parts: int | None = None,
) -> Partition:
    """Assign each landmark to the part seeing it most.  With no camera
    partition given, landmarks are split into balanced contiguous blocks
    (the right default when cameras are replicated, as in
    dist/schur_reduce.py)."""
    pt_idx = np.asarray(pt_idx)
    if cam_part is None:
        assert n_parts is not None
        # balanced contiguous blocks over landmark index
        bounds = np.linspace(0, n_landmarks, n_parts + 1).astype(np.int64)
        part = np.searchsorted(bounds[1:], np.arange(n_landmarks), side="right")
        return Partition(part.astype(np.int64), n_parts)
    cam_idx = np.asarray(cam_idx)
    n_parts = cam_part.n_parts
    votes = np.zeros((n_landmarks, n_parts), np.int64)
    np.add.at(votes, (pt_idx, cam_part.part[cam_idx]), 1)
    part = votes.argmax(axis=1)
    # unobserved landmarks: spread round-robin for balance
    unobserved = votes.sum(axis=1) == 0
    part[unobserved] = np.arange(unobserved.sum()) % n_parts
    return Partition(part.astype(np.int64), n_parts)


def cut_stats(edges_i, edges_j, partition: Partition) -> dict:
    """Edge cut and balance diagnostics for a pose partition."""
    p = partition.part
    cut = int(np.sum(p[np.asarray(edges_i)] != p[np.asarray(edges_j)]))
    counts = partition.counts()
    balance = float(counts.max() / max(1.0, counts.mean()))
    return dict(edge_cut=cut, counts=counts.tolist(), imbalance=balance)


__all__ = ["Partition", "partition_poses_bfs", "partition_landmarks", "cut_stats"]
