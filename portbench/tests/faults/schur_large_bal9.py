"""The faults of a cell on the ``schur_large_bal9`` entry: the same program
path as the ``schur_large`` entry (``solver.schur_large.solve_schur_large``)
on 9-parameter cameras, so the same four faults, planted where the program
makes what they break (``faults/schur_large.py``): a step that returns its
state unchanged, the second half of the observations weighing nothing, the
reported chi2 1% high, one landmark moved by 0.1."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location("portbench_faults_schur_large_shared",
                                               pathlib.Path(__file__).with_name("schur_large.py"))
_shared = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_shared)

state_unchanged = _shared.state_unchanged
half_left_out = _shared.half_left_out
chi2_altered = _shared.chi2_altered
variable_altered = _shared.variable_altered
