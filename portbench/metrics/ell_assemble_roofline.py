"""ell_assemble_roofline (%, device trace): the bound of every
``ell_assemble`` call of the profiled solves (``roofline.ell_assemble_count``)
over the time its two launches held the card (their union: the second is a
programmatic dependent launch)."""

from portbench import roofline
from portbench.probes import Call

KERNELS = ("assemble_linearize", "assemble_rows")
PROBES = [Call("ell_assemble", "pyslam_tpu_torch.solver.bcsr:ell_assemble", roofline.ell_assemble_count)]


def read(run):
    return run.roofline_pct("ell_assemble", KERNELS, roofline.ell_assemble_bound)
