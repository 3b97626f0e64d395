"""bal_rows_roofline (%, device trace): the bound of every launch of the
9-parameter camera's ``bal_rows`` kernel (``bal_cam9`` cameras, 90 rows an
observation) in the profiled solves over the time the card ran that
instantiation.

A call's bytes are counted from its own tensors: each input byte once (the
camera and landmark tables, the indices, the observations, sqrt_info and
the weights) and each output byte once (the cost, and the rows at their own
width where the call asks for them); its operations are those of each
observation (``FLOP``).  The bound is the larger of bytes over the memory
rate and operations over the float32 rate (``roofline.bound_s``).  Only
9-dof calls are counted, so that a cell without them gives no reading."""

from portbench import roofline
from portbench.probes import Call

# the 9-dof instantiations, by the name the trace gives them
KERNELS = ("bal_rows_kernel<float, 9,", "bal_rows_kernel<double, 9,")

# operations of one observation, counted from csrc/bal_rows.cu, by whether
# the call writes rows: the projection, residual and loss (about 60); with
# rows also the 2 x 12 Jacobian and the 12 gradient rows of 3 and the upper
# Hessian and W rows of 5 (about 600)
FLOP = {False: 60, True: 600}


def count(args, kwargs, out):
    """``schur_large.bal_rows(poses, lms, cam_idx, pt_idx, obs, f, k1, k2,
    sqrt_info, weight, loss, rows=True, chunk=None)``: shapes only; None
    for a 6-dof call (se3 poses) or one with no launch."""
    poses, M = args[0], args[2].shape[0]
    if M == 0 or poses.dim() != 2:
        return None
    tensors = [t for t in args[:10] if t is not None] + [t for t in out if t is not None]
    return dict(bytes=roofline.nbytes(*tensors), flop=FLOP[out[1] is not None] * M,
                dtype=str(poses.dtype).replace("torch.", ""))


PROBES = [Call("bal_rows", "pyslam_tpu_torch.solver.schur_large:bal_rows", count)]


def _bound(record):
    return roofline.bound_s(record["bytes"], record["flop"], record["dtype"])


def read(run):
    return run.roofline_pct("bal_rows", KERNELS, _bound)
