"""slot_reduce_roofline (%, device trace): the bound of every
``slot_reduce`` call of the profiled solves (``roofline.slot_reduce_count``)
over the time the card ran its kernels."""

from portbench import roofline
from portbench.probes import Call

KERNELS = ("slot_reduce_kernel", "slot_rows_kernel", "slot_block_kernel")
PROBES = [Call("slot_reduce", "pyslam_tpu_torch.solver.cuda_ops:_slot_reduce", roofline.slot_reduce_count)]


def read(run):
    return run.roofline_pct("slot_reduce", KERNELS, roofline.slot_reduce_bound)
