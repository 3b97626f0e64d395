"""Plain reference of bundle adjustment in BAL's full form, each camera's 9
parameters estimated (rotation, translation, f, k1, k2): Levenberg-Marquardt
on the reduced camera system, solved by block-Jacobi preconditioned
conjugate gradients (Agarwal et al., "Bundle Adjustment in the Large",
ECCV 2010; Triggs et al., "Bundle Adjustment: A Modern Synthesis", 1999).

Plain PyTorch over the generator's tensors: no kernel, plan or value of
the program under test.  ``ba_schur_lm``'s algorithm (its ``pcg``,
``_damp`` and ``_inverse``) on 9-dof cameras:

* residual r = pred - obs of a Snavely camera whose intrinsics are part of
  the state: p = R X + t, pn = -p_xy / p_z, pred = f (1 + k1 |pn|^2 + k2
  |pn|^4) pn; cost 1/2 sum r^2; camera 0 fixed whole (pose and
  intrinsics); a landmark that no observation reaches is left where it is;
* a camera's tangent [rho, phi, df, dk1, dk2]: the Jacobian's intrinsics
  columns d pred / d [f, k1, k2] = [d pn, f r2 pn, f r2^2 pn] after the
  pose's six; updates exp(dx[:6]) T, [f, k1, k2] + dx[6:] and X + dx;
* Marquardt damping H_ii += lam max(diag(H_ii), 1e-12) on every camera and
  landmark block; S = Hpp - W Hll^-1 W^T never formed; PCG from 0 under
  the exact 9 x 9 block diagonal of S, stopped before an iteration where
  |r| <= rtol |b| or after ``pcg_max_iters``; an iteration with r.z <= 0
  or p.Ap <= 0 keeps its residual and direction;
* the trial point linearized whole: accepted where its cost is below the
  current one (lam / lambda_down), else lam * lambda_up; stop on a small
  accepted update, a cost below ``min_cost``, or an accepted step that
  lowers the cost by less than the factor ``min_cost_decrease``; the best
  point is returned.

A camera is held as the program holds a ``bal_cam9`` one, (C, 19) =
[vec(T), f, k1, k2].  Observations are handled in chunks, so that float64
fits beside nothing else on the card."""

from __future__ import annotations

import torch

from .. import lie
from ..arith import Arith
from .ba_schur_lm import _damp, _first_cost, _inverse, pcg

_CHUNK = 1 << 20
DP = 9  # a camera's dof


def _split(cams):
    """(T (C, 4, 4), [f, k1, k2] (C, 3)) of cameras (C, 19)."""
    return cams[:, :16].reshape(-1, 4, 4), cams[:, 16:]


def _join(T, K):
    return torch.cat([T.reshape(-1, 16), K], -1)


class _Problem:
    def __init__(self, problem: dict, ar: Arith):
        self.ar = ar
        self.ci = problem["cam_idx"]
        self.li = problem["pt_idx"]
        self.obs = ar.t(problem["obs"])
        self.C = problem["poses_init"].shape[0]
        self.L = problem["pts_init"].shape[0]
        self.M = self.obs.shape[0]

    def chunks(self):
        for lo in range(0, self.M, _CHUNK):
            yield lo, min(lo + _CHUNK, self.M)

    def residual(self, T, K, X, lo, hi, jacobians):
        """r (n, 2), and where asked J_cam (n, 2, 9), J_pt (n, 2, 3)."""
        mm = self.ar.mm
        ci, li = self.ci[lo:hi], self.li[lo:hi]
        R = T[ci, :3, :3]
        p = mm(R, X[li][..., None])[..., 0] + T[ci, :3, 3]
        x, y, z = p.unbind(-1)
        iz = 1.0 / z
        pn = torch.stack([-x * iz, -y * iz], -1)
        r2 = (pn * pn).sum(-1)
        f, k1, k2 = K[ci].unbind(-1)
        d = 1 + r2 * (k1 + k2 * r2)
        r = (f * d)[..., None] * pn - self.obs[lo:hi]
        if not jacobians:
            return r
        o = torch.zeros_like(z)
        # d pn / d p, then d pred / d pn = f (d I + pn (d d / d pn)^T), d d / d pn = 2 (k1 + 2 k2 r2) pn
        P = torch.stack([torch.stack([-iz, o, x * iz * iz], -1), torch.stack([o, -iz, y * iz * iz], -1)], -2)
        dd = (2 * (k1 + 2 * k2 * r2))[..., None] * pn
        eye2 = torch.eye(2, dtype=p.dtype, device=p.device)
        A = mm(f[..., None, None] * (d[..., None, None] * eye2 + pn[..., :, None] * dd[..., None, :]), P)
        eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[:-1] + (3, 3))
        dp = torch.cat([eye, -lie.wedge(p)], -1)  # d(exp(xi) p)/d xi at 0
        J_intr = torch.stack([d[..., None] * pn, (f * r2)[..., None] * pn, (f * r2 * r2)[..., None] * pn], -1)
        return r, torch.cat([mm(A, dp), J_intr], -1), mm(A, R)

    def cost(self, T, K, X):
        total = torch.zeros((), dtype=self.ar.dtype, device=T.device)
        for lo, hi in self.chunks():
            total = total + 0.5 * (self.residual(T, K, X, lo, hi, False) ** 2).sum()
        return total

    def linearize(self, T, K, X):
        mm, dt, dev = self.ar.mm, self.ar.dtype, T.device
        Hpp = torch.zeros(self.C, DP, DP, dtype=dt, device=dev)
        gp = torch.zeros(self.C, DP, dtype=dt, device=dev)
        Hll = torch.zeros(self.L, 3, 3, dtype=dt, device=dev)
        gl = torch.zeros(self.L, 3, dtype=dt, device=dev)
        W = torch.empty(self.M, DP, 3, dtype=dt, device=dev)
        cost = torch.zeros((), dtype=dt, device=dev)
        for lo, hi in self.chunks():
            r, Jc, Jl = self.residual(T, K, X, lo, hi, True)
            ci, li = self.ci[lo:hi], self.li[lo:hi]
            cost = cost + 0.5 * (r ** 2).sum()
            Jct, Jlt = Jc.transpose(-1, -2), Jl.transpose(-1, -2)
            Hpp.index_add_(0, ci, mm(Jct, Jc))
            gp.index_add_(0, ci, -mm(Jct, r[..., None])[..., 0])
            Hll.index_add_(0, li, mm(Jlt, Jl))
            gl.index_add_(0, li, -mm(Jlt, r[..., None])[..., 0])
            W[lo:hi] = mm(Jct, Jl)
        eye3 = torch.eye(3, dtype=dt, device=dev)
        # camera 0 fixed whole: its block the identity, its gradient and couplings 0
        Hpp[0] = torch.eye(DP, dtype=dt, device=dev)
        gp[0] = 0
        W[self.ci == 0] = 0
        # landmarks that nothing observes: the identity and no gradient
        dead = torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1) == 0
        Hll[dead] = eye3
        gl[dead] = 0
        return cost, (Hpp, gp, Hll, gl, W)


def _step(P: _Problem, lin, T, K, X, lam, rtol, max_iters):
    """The damped Schur step from (T, K, X): the trial point and |dx|."""
    mm = P.ar.mm
    Hpp, gp, Hll, gl, W = lin
    C = P.C
    Hpp_d, Hll_inv = _damp(Hpp, lam), _inverse(_damp(Hll, lam))
    ci, li = P.ci, P.li
    Wt = W.transpose(-1, -2)

    def by_cam(v):
        return torch.zeros(C, v.shape[-1], dtype=v.dtype, device=v.device).index_add_(0, ci, v)

    def by_lm(v):
        return torch.zeros(P.L, v.shape[-1], dtype=v.dtype, device=v.device).index_add_(0, li, v)

    t = mm(Hll_inv, gl[..., None])[..., 0]
    b = (gp - by_cam(mm(W, t[li][..., None])[..., 0])).reshape(-1)
    coupling = torch.zeros_like(Hpp_d)  # the sum of W Hll^-1 W^T by camera, chunk by chunk
    for lo, hi in P.chunks():
        coupling.index_add_(0, ci[lo:hi], mm(mm(W[lo:hi], Hll_inv[li[lo:hi]]), Wt[lo:hi]))
    D_inv = _inverse(Hpp_d - coupling)

    def matvec(v):
        xb = v.reshape(C, DP)
        u = mm(Hll_inv, by_lm(mm(Wt, xb[ci][..., None])[..., 0])[..., None])[..., 0]
        return (mm(Hpp_d, xb[..., None])[..., 0] - by_cam(mm(W, u[li][..., None])[..., 0])).reshape(-1)

    def precond(v):
        return mm(D_inv, v.reshape(C, DP)[..., None])[..., 0].reshape(-1)

    x, _ = pcg(matvec, precond, b, rtol, max_iters, guard=True)
    dxp = x.reshape(C, DP).clone()
    dxp[0] = 0
    dxl = mm(Hll_inv, (gl - by_lm(mm(Wt, dxp[ci][..., None])[..., 0]))[..., None])[..., 0]
    norm = torch.sqrt((dxp ** 2).sum() + (dxl ** 2).sum())
    return (mm(lie.se3_exp(dxp[:, :6], mm), T), K + dxp[:, 6:], X + dxl), norm


def solve(problem: dict, config: dict, ar: Arith) -> dict:
    """The configuration's solve from the generator's start: the best
    point, its cost and the LM iterations run."""
    o, s = config["options"], config["solver"]
    if o["method"] != "lm":
        raise ValueError("the reference runs method 'lm' only")
    P = _Problem(problem, ar)
    T, K = _split(ar.t(start(problem)["poses"]))
    X = ar.t(problem["pts_init"])
    cost, lin = P.linearize(T, K, X)
    chi2 = float(cost)
    best = (T, K, X, chi2)
    lam = o["lambda_init"]
    it = 0
    history = []  # (accepted, cost after the iteration) an iteration
    for it in range(1, o["max_iters"] + 1):
        (Tt, Kt, Xt), norm = _step(P, lin, T, K, X, lam, s["pcg_rtol"], s["pcg_max_iters"])
        cost_t, lin_t = P.linearize(Tt, Kt, Xt)
        new, norm = float(cost_t), float(norm)
        accept = new < chi2
        prev = chi2
        if accept:
            T, K, X, lin, chi2 = Tt, Kt, Xt, lin_t, new
            lam = max(lam * o["lambda_down"], o["lambda_min"])
        else:
            lam = min(lam * o["lambda_up"], o["lambda_max"])
        del lin_t
        history.append((accept, chi2))
        if new < best[3]:
            best = (Tt, Kt, Xt, new)
        if (accept and norm < o["min_update_norm"]) or new < o["min_cost"] or (
                accept and not new < prev * o["min_cost_decrease"]):
            break
    return dict(poses=_join(best[0], best[1]), landmarks=best[2], chi2=best[3], iterations=it, history=history,
                first_cost=_first_cost(history))


def cost(problem: dict, answer: dict, ar: Arith) -> float:
    P = _Problem(problem, ar)
    T, K = _split(ar.t(answer["poses"]))
    return float(P.cost(T, K, ar.t(answer["landmarks"])))


def distances(a: dict, b: dict):
    """The distance of every variable of a from b, in float64: each camera
    by the norm of [the tangent of T_a T_b^-1, (f_a - f_b) / f_b, k1_a -
    k1_b, k2_a - k2_b], then each landmark by the norm of its difference.
    The focal length counts relative to itself: in pixels (500 to 1,500) it
    would swamp the tangents (of order 1e-2) and the distortion terms."""
    Ta, Ka = _split(a["poses"].to(torch.float64))
    Tb, Kb = _split(b["poses"].to(torch.float64))
    xi = lie.se3_log(Ta @ lie.se3_inv(Tb))
    dk = torch.cat([((Ka[:, 0] - Kb[:, 0]) / Kb[:, 0])[:, None], Ka[:, 1:] - Kb[:, 1:]], -1)
    dl = a["landmarks"].to(torch.float64) - b["landmarks"].to(torch.float64)
    return torch.cat([torch.linalg.vector_norm(torch.cat([xi, dk], -1), dim=-1), torch.linalg.vector_norm(dl, dim=-1)])


def start(problem: dict) -> dict:
    """The generator's start, cameras as (C, 19)."""
    return dict(poses=_join(problem["poses_init"], problem["intrinsics_init"]), landmarks=problem["pts_init"])
