"""ell_pcg_roofline (%, device trace): the bound of every ``ell_pcg`` call
of the profiled solves, its iterations as run (``roofline.ell_pcg_count``),
over the time the card ran the kernel."""

from portbench import roofline
from portbench.probes import Call

KERNELS = ("ell_pcg_kernel",)
PROBES = [Call("ell_pcg", "pyslam_tpu_torch.solver.bcsr:ell_pcg", roofline.ell_pcg_count)]


def read(run):
    return run.roofline_pct("ell_pcg", KERNELS, roofline.ell_pcg_bound)
