"""The twin of ``tests/test_comm_model.py``.  This file holds no test of its
own: what the reference checks has no meaning for the port, and what the
port counts in its place is held elsewhere.

The reference lowers each sharded LM step to StableHLO on an 8-device
mesh and holds the payloads of its collective ops (elements of
``all_reduce`` / ``all_gather`` / ``reduce_scatter`` /
``collective_permute``, each CG-loop op once in the static text) to
``bench/scaling.py``'s ``comm_model``.  The port compiles nothing: its
collectives are ``torch.distributed`` calls made by ``dist.Mesh.psum`` and
``Mesh.all_gather``, counted in ``dist.COLLECTIVES``, and its mesh routes
price logical bytes, not XLA's tiles
(``test_torch_solve_auto.py::test_mesh_route_prices_logical_bytes``).
Each case's counterpart is the count of collectives an LM iteration and a
CG iteration make, on gloo ranks:

  * ``TestCommModelMatchesHLO::test_factor_parallel``:
    ``test_torch_factor_parallel.py::test_collectives_per_iteration``
    (three sums an LM iteration: H, then g with chi2, then the trial cost;
    no gather);
  * ``TestCommModelMatchesHLO::test_schur_reduce``:
    ``test_torch_schur_sharded.py::test_collectives_per_iteration``
    (4 + the CG budget sums an LM iteration, one gather);
  * ``TestCommModelMatchesHLO::test_schur_cm``:
    ``test_torch_schur_cm.py::test_collectives_per_iteration``
    (4 + the CG budget sums an LM iteration, one gather);
  * ``TestCommModelMatchesHLO::test_pose_sharded``:
    ``test_torch_pose_sharded.py::test_the_local_product_is_ell_matvec``
    (2 + 2 x CG budget sums and 2 + CG budget gathers an LM iteration, one
    gather for the result).
"""
