"""cg_iterations (iters, program counter): CG iterations a solve ran in the
``ell_pcg`` kernel, read from each call's device count after the window."""

from portbench import roofline
from portbench.probes import Call

PROBES = [Call("ell_pcg", "pyslam_tpu_torch.solver.bcsr:ell_pcg", roofline.ell_pcg_count)]


def read(run):
    return run.per_solve("ell_pcg", lambda r: int(r["iterations"].sum()))
