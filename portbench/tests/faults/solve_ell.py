"""The faults of a cell on the ``solve_ell`` entry (``solver.bcsr.solve_ell``),
each planted where the program makes what it breaks.
``test_portbench_faults.py`` finds this file by the entry's name and plants
each fault under a whole run."""


def state_unchanged(monkeypatch):
    """Every step returns its state unchanged: the LM step's retraction
    gives back the graph it was handed."""
    from pyslam_tpu_torch.graph.core import FactorGraph

    monkeypatch.setattr(FactorGraph, "retract_all", lambda self, dx: self)


def half_left_out(monkeypatch):
    """The second half of the edges weigh nothing."""
    from pyslam_tpu_torch.solver import bcsr

    batches = bcsr.ell_assemble_batches

    def half_batches(graph):
        out = batches(graph)
        if out is None:
            return None
        halved = []
        for b in out:
            w = b.weight.clone()
            w[w.shape[0] // 2:] = 0
            halved.append(b._replace(weight=w))
        return halved

    monkeypatch.setattr(bcsr, "ell_assemble_batches", half_batches)


def _altered(monkeypatch, what):
    """The answer altered where the solve returns it: the chi2 it reports
    1% high, or one pose moved by 0.1."""
    from pyslam_tpu_torch.graph.core import FactorGraph, VariableBlock
    from pyslam_tpu_torch.solver import bcsr

    def moved(graph):
        b = graph.blocks["poses"]
        v = b.values.clone()
        v[v.shape[0] // 2, :3, 3] += 0.1
        return FactorGraph({**graph.blocks, "poses": VariableBlock(b.kind, v, b.const_mask)}, graph.batches)

    ell = bcsr.solve_ell

    def ell_altered(*args, **kwargs):
        graph, info = ell(*args, **kwargs)
        return (graph, info._replace(chi2=info.chi2 * 1.01)) if what == "chi2" else (moved(graph), info)

    monkeypatch.setattr(bcsr, "solve_ell", ell_altered)


def chi2_altered(monkeypatch):
    _altered(monkeypatch, "chi2")


def variable_altered(monkeypatch):
    _altered(monkeypatch, "variable")
