"""Preconditioned conjugate gradients for the normal equations.

Counterpart of ``pyslam_tpu/solver/linear.py::pcg_solve``: the same
recurrences and the same stop rule, ``norm(r) > rtol * norm(b) and
it < max_iters``, tested before every iteration.  The reference runs the
loop on the device under ``lax.while_loop``; here the loop runs on the
host and reads the stop test back from the device once per CG iteration
(``HOST_READS["pcg"]`` counts those reads, ``HOST_READS["lm"]`` the LM
loop's).
"""

from __future__ import annotations

import torch

# Device-to-host scalar reads made by the solver loops; reset and read by
# callers that account for them (chip_smoke.py).
HOST_READS = {"pcg": 0, "lm": 0}


def reset_host_reads():
    for k in HOST_READS:
        HOST_READS[k] = 0


def pcg_solve(matvec, b, precond=None, x0=None, rtol=1e-6, max_iters=500):
    """Preconditioned CG: solve A x = b given only a matvec closure.
    Returns (x, iterations)."""
    if precond is None:
        precond = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    tol = rtol * torch.linalg.norm(b)

    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    it = 0
    while it < max_iters:
        HOST_READS["pcg"] += 1
        if not bool(torch.linalg.norm(r) > tol):
            break
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it
