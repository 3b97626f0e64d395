"""Linear solvers for the normal equations.

Counterpart of ``pyslam_tpu/solver/linear.py``:

  * ``cholesky_solve`` — dense Cholesky (``torch.linalg.cholesky_ex``) and
    two triangular solves.  A failed factorization (H not positive
    definite) gives NaN, which the LM loop treats as a rejected step, as in
    the reference; ``torch.linalg.cholesky`` would raise instead.
  * ``damp_marquardt`` — H + lam * diag(max(diag(H), floor)).
  * ``pcg_solve`` — preconditioned conjugate gradients, with the same
    recurrences and the same stop rule as the reference, ``norm(r) > rtol *
    norm(b) and it < max_iters``, tested before every iteration, for any
    matvec and preconditioner closures.  The reference runs the loop on the
    device under ``lax.while_loop``; here the loop runs on the host and
    reads the stop test back from the device once per CG iteration
    (``HOST_READS["pcg"]`` counts those reads, ``HOST_READS["lm"]`` the LM
    loop's).  ``solve_ell`` does not come here on the card: its ELL
    product and block-Jacobi preconditioner are the ``cuda_ops.ell_pcg``
    kernel, the whole loop in one launch with no host read.  The Schur
    path (``schur.schur_solve_pcg``) does: its loop is bound by the host's
    launches, a read costs less than the launches that would mask the
    state on the device, and ``profile_port.py`` times both.
"""

from __future__ import annotations

import torch

from ..observability import span

# Device-to-host scalar reads made by the solver loops; reset and read by
# callers that account for them (chip_smoke.py).  Each is also a ``read``
# span (``observability.SPAN_NS``): the host's wait on the device.
HOST_READS = {"pcg": 0, "lm": 0}

# The LM loops' trials by their accept decision (``host_loop``, ``lm.solve``):
# a rejected trial's linearization and linear solve are work thrown away.
LM_TRIALS = {"accepted": 0, "rejected": 0}


def reset_host_reads():
    for k in HOST_READS:
        HOST_READS[k] = 0


def reset_lm_trials():
    for k in LM_TRIALS:
        LM_TRIALS[k] = 0


def cholesky_solve(H, g):
    """Solve H dx = g for SPD H (..., D, D), g (..., D) via Cholesky; NaN
    where the factorization fails (by design: no host read, no exception)."""
    L, info = torch.linalg.cholesky_ex(H)
    y = torch.linalg.solve_triangular(L, g[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]
    return torch.where((info != 0)[..., None], float("nan"), x)


def damp_marquardt_(H, lam, floor=1e-12):
    """In place: H += lam * diag(max(diag(H), floor)).  Returns H."""
    d = H.diagonal()
    d.add_(lam * torch.clamp(d, min=floor))
    return H


def damp_marquardt(H, lam, floor=1e-12):
    """Levenberg-Marquardt damping H + lam * diag(H) (Marquardt scaling,
    which is unit-free).  The floor keeps gauge-free directions damped.
    Returns a new matrix."""
    return damp_marquardt_(H.clone(), lam, floor)


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
        running = torch.linalg.norm(r) > tol
        with span("read"):
            running = bool(running)
        if not running:
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

