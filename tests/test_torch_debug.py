"""The twin of ``tests/test_debug.py``.  Every case is held by
``tests/test_torch_tools.py``, on the reference's own graph
(``se2_loop(n_poses=10, n_loops=2, seed=0)``) and faults; this file holds
no test of its own.

  * ``TestValidateGraph::test_clean``, ``::test_out_of_range_index``,
    ``::test_nonfinite_measurement``, ``::test_negative_weight``:
    ``test_torch_tools.py::test_validate_graph_gives_the_reference_messages``
    (the reference's messages, list for list, and ``assert_graph_valid``
    raising on each fault);
  * ``TestNanDebug::test_toggle_restores``: the reference toggles
    ``jax_debug_nans``, which has no meaning for the port; its
    ``nan_debug`` checks every op's output under a ``TorchDispatchMode``
    and restores its state on exit,
    ``test_torch_tools.py::test_nan_debug_raises_at_the_first_nan_and_restores``.
"""
