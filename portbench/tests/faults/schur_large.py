"""The faults of a cell on the ``schur_large`` entry
(``solver.schur_large.solve_schur_large``), each planted where the program
makes what it breaks.  ``test_portbench_faults.py`` finds this file by the
entry's name and plants each fault under a whole run."""


def state_unchanged(monkeypatch):
    """Every step returns its state unchanged: the back-substitution's
    retraction leaves cameras and landmarks where they were."""
    from pyslam_tpu_torch.solver import schur_large

    monkeypatch.setattr(schur_large, "_back_substitute_retract",
                        lambda parts, Hll_inv, poses, lms, x: ((poses, lms), x.new_zeros(())))


def half_left_out(monkeypatch):
    """The second half of the observations weigh nothing."""
    from pyslam_tpu_torch.solver import schur_large

    obs_rows = schur_large._obs_rows

    def half_rows(plan, poses, lms):
        cost, rows = obs_rows(plan, poses, lms)
        cost[plan.M // 2:] = 0
        rows[plan.M // 2:] = 0
        return cost, rows

    monkeypatch.setattr(schur_large, "_obs_rows", half_rows)


def _altered(monkeypatch, what):
    """The answer altered where the solve returns it: the chi2 it reports
    1% high, or one landmark moved by 0.1."""
    from pyslam_tpu_torch.graph.core import FactorGraph, VariableBlock
    from pyslam_tpu_torch.solver import schur_large

    def moved(graph):
        b = graph.blocks["landmarks"]
        v = b.values.clone()
        v[v.shape[0] // 2] += 0.1
        return FactorGraph({**graph.blocks, "landmarks": VariableBlock(b.kind, v, b.const_mask)}, graph.batches)

    large = schur_large.solve_schur_large

    def large_altered(*args, **kwargs):
        graph, chi2, history = large(*args, **kwargs)
        return (graph, chi2 * 1.01, history) if what == "chi2" else (moved(graph), chi2, history)

    monkeypatch.setattr(schur_large, "solve_schur_large", large_altered)


def chi2_altered(monkeypatch):
    _altered(monkeypatch, "chi2")


def variable_altered(monkeypatch):
    _altered(monkeypatch, "variable")
