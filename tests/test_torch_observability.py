"""The twin of ``tests/test_observability.py``.  Every case is held by
``tests/test_torch_tools.py`` against the JAX package; this file holds no
test of its own.

  * ``TestIterationLog::test_records_and_jsonl``:
    ``test_torch_tools.py::test_iteration_log_matches_reference`` (the
    reference's solve of ``se2_loop(30)``, its records within 1e-8, the
    JSONL file with its summary line);
  * ``TestCheckpoint::test_pytree_roundtrip``:
    ``test_torch_tools.py::test_state_roundtrip``, and the reference's npz
    layout in ``test_torch_tools.py::test_checkpoint_keeps_the_reference_layout``;
  * ``TestCheckpoint::test_graph_checkpoint_resume_exact``:
    ``test_torch_tools.py::test_graph_checkpoint_resume_exact``;
  * ``TestCheckpoint::test_profile_trace_smoke``: the reference traces
    through ``jax.profiler``; the port's ``profile_trace`` writes a
    ``torch.profiler`` ``trace.json`` that holds the solver's spans
    (``observability.span``), held by
    ``test_torch_tools.py::test_profile_trace_and_timed``.  The reference's
    ``timed`` has no counterpart in the port: it timed the enqueue of
    device work, and the spans take its place (``tests/test_torch_spans.py``).
"""
