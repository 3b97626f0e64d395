"""The multi-device layer of the port, on ``torch.distributed``.

Counterpart of ``pyslam_tpu/dist``.  One process per device (multi-
controller SPMD, PyTorch's idiom): every rank calls the same entry point
with the whole graph, builds the same host plans, keeps its own shard on
``mesh.device`` and gets back the whole solved graph.  NCCL on CUDA
devices, gloo on the CPU.

  * ``mesh``            — ``init_distributed``, ``make_mesh``, the ``Mesh``
                          and its two collectives (``psum``, ``all_gather``)
  * ``factor_parallel`` — factors split over the ranks, H, g and chi2
                          summed (the data-parallel analogue)
  * ``partitioner``     — variable-block partitioning, numpy
  * ``pose_sharded``    — variable-sharded pose graphs (the tensor-parallel
                          analogue)
  * ``schur_reduce``    — landmark-sharded Schur bundle adjustment (bench
                          config 5's path)
  * ``schur_cm``        — the same sharding over ``solve_schur_large``'s
                          per-rank machinery (camera-sorted observations,
                          chunked linearization): the reference's
                          component-major path, past ``route_auto``'s
                          observation crossover

The mesh is one-dimensional, so the reference's ``axis`` arguments (the
mesh axis to shard over) are not taken, and a step closes over the
rank's shard instead of taking the sharded arrays (``make_sharded_lm_step``
returns the rank's graph where the reference returns the padded one).
Posterior covariance over the landmark-sharded layout:
``sharded_pose_marginals`` and ``sharded_landmark_marginals`` (in
``schur_reduce``).
"""

from .factor_parallel import make_sharded_lm_step, pad_batch, shard_graph, solve_factor_parallel
from .mesh import COLLECTIVES, Mesh, init_distributed, make_mesh, reset_collectives
from .partitioner import Partition, cut_stats, partition_landmarks, partition_poses_bfs
from .pose_sharded import shard_pose_graph, solve_pose_sharded
from .schur_cm import ShardedCM, make_cm_step, shard_ba_cm, solve_schur_cm
from .schur_reduce import shard_ba, sharded_landmark_marginals, sharded_pose_marginals, solve_schur_sharded


__all__ = [
    "COLLECTIVES",
    "Mesh",
    "make_mesh",
    "init_distributed",
    "reset_collectives",
    "make_sharded_lm_step",
    "pad_batch",
    "shard_graph",
    "solve_factor_parallel",
    "Partition",
    "cut_stats",
    "partition_landmarks",
    "partition_poses_bfs",
    "shard_ba",
    "solve_schur_sharded",
    "sharded_pose_marginals",
    "sharded_landmark_marginals",
    "ShardedCM",
    "shard_ba_cm",
    "make_cm_step",
    "solve_schur_cm",
    "shard_pose_graph",
    "solve_pose_sharded",
]
