"""Plain reference of bundle adjustment in BAL's form: Levenberg-Marquardt
on the reduced camera system, solved by block-Jacobi preconditioned
conjugate gradients (Agarwal et al., "Bundle Adjustment in the Large",
ECCV 2010; Triggs et al., "Bundle Adjustment: A Modern Synthesis", 1999).

Plain PyTorch over the generator's tensors: no kernel, plan or value of
the program under test.  The same problem and the same algorithm as the
configuration states:

* residual r = pred - obs of a Snavely camera with its intrinsics held:
  p = R X + t, pn = -p_xy / p_z, pred = f (1 + k1 |pn|^2 + k2 |pn|^4) pn;
  cost 1/2 sum r^2; camera 0 fixed; a landmark that no observation
  reaches is left where it is;
* tangents [rho, phi], updates exp(dx) T and X + dx;
* Marquardt damping H_ii += lam max(diag(H_ii), 1e-12) on every camera and
  landmark block; S = Hpp - W Hll^-1 W^T never formed; PCG from 0 under
  the exact block diagonal of S, stopped before an iteration where
  |r| <= rtol |b| or after ``pcg_max_iters``; an iteration with
  r.z <= 0 or p.Ap <= 0 keeps its residual and direction;
* the trial point linearized whole: accepted where its cost is below the
  current one (lam / lambda_down), else lam * lambda_up; stop on a small
  accepted update, a cost below ``min_cost``, or an accepted step that
  lowers the cost by less than the factor ``min_cost_decrease``; the best
  point is returned.

Observations are handled in chunks, so that float64 fits beside nothing
else on the card."""

from __future__ import annotations

import torch

from .. import lie
from ..arith import Arith

_CHUNK = 1 << 20


class _Problem:
    def __init__(self, problem: dict, ar: Arith):
        self.ar = ar
        self.ci = problem["cam_idx"]
        self.li = problem["pt_idx"]
        self.obs = ar.t(problem["obs"])
        self.intrinsics = ar.t(problem["intrinsics"])
        self.C = problem["poses_init"].shape[0]
        self.L = problem["pts_init"].shape[0]
        self.M = self.obs.shape[0]

    def chunks(self):
        for lo in range(0, self.M, _CHUNK):
            yield lo, min(lo + _CHUNK, self.M)

    def residual(self, T, X, lo, hi, jacobians):
        """r (n, 2), and where asked J_cam (n, 2, 6), J_pt (n, 2, 3)."""
        mm = self.ar.mm
        ci, li = self.ci[lo:hi], self.li[lo:hi]
        R = T[ci, :3, :3]
        p = mm(R, X[li][..., None])[..., 0] + T[ci, :3, 3]
        x, y, z = p.unbind(-1)
        iz = 1.0 / z
        pn = torch.stack([-x * iz, -y * iz], -1)
        r2 = (pn * pn).sum(-1)
        f, k1, k2 = self.intrinsics[ci].unbind(-1)
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
        return r, mm(A, dp), mm(A, R)

    def cost(self, T, X):
        total = torch.zeros((), dtype=self.ar.dtype, device=T.device)
        for lo, hi in self.chunks():
            total = total + 0.5 * (self.residual(T, X, lo, hi, False) ** 2).sum()
        return total

    def linearize(self, T, X):
        mm, dt, dev = self.ar.mm, self.ar.dtype, T.device
        Hpp = torch.zeros(self.C, 6, 6, dtype=dt, device=dev)
        gp = torch.zeros(self.C, 6, dtype=dt, device=dev)
        Hll = torch.zeros(self.L, 3, 3, dtype=dt, device=dev)
        gl = torch.zeros(self.L, 3, dtype=dt, device=dev)
        W = torch.empty(self.M, 6, 3, dtype=dt, device=dev)
        cost = torch.zeros((), dtype=dt, device=dev)
        for lo, hi in self.chunks():
            r, Jc, Jl = self.residual(T, X, lo, hi, True)
            ci, li = self.ci[lo:hi], self.li[lo:hi]
            cost = cost + 0.5 * (r ** 2).sum()
            Jct, Jlt = Jc.transpose(-1, -2), Jl.transpose(-1, -2)
            Hpp.index_add_(0, ci, mm(Jct, Jc))
            gp.index_add_(0, ci, -mm(Jct, r[..., None])[..., 0])
            Hll.index_add_(0, li, mm(Jlt, Jl))
            gl.index_add_(0, li, -mm(Jlt, r[..., None])[..., 0])
            W[lo:hi] = mm(Jct, Jl)
        eye3 = torch.eye(3, dtype=dt, device=dev)
        # camera 0 fixed: its block the identity, its gradient and couplings 0
        Hpp[0] = torch.eye(6, dtype=dt, device=dev)
        gp[0] = 0
        W[self.ci == 0] = 0
        # landmarks that nothing observes: the identity and no gradient
        dead = torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1) == 0
        Hll[dead] = eye3
        gl[dead] = 0
        return cost, (Hpp, gp, Hll, gl, W)


def _damp(H, lam):
    d = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12)
    return H + lam * torch.diag_embed(d)


def _inverse(H):
    """Batched inverse through the Cholesky factor; NaN where H is not
    positive definite."""
    L, info = torch.linalg.cholesky_ex(H)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device).expand(H.shape)
    Y = torch.linalg.solve_triangular(L, eye, upper=False)
    inv = torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True)
    return torch.where((info != 0)[..., None, None], float("nan"), inv)


def pcg(matvec, precond, b, rtol, max_iters, guard):
    """Preconditioned CG from 0; the stop test before every iteration.
    With ``guard`` an iteration where r.z <= 0 or p.Ap <= 0 moves x by
    nothing and keeps r and p."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p, rz = z, torch.dot(r, z)
    tol2 = rtol * rtol * torch.dot(b, b)
    it = 0
    while it < max_iters and bool(torch.dot(r, r) > tol2):
        Ap = matvec(p)
        pAp = torch.dot(p, Ap)
        if guard and not (bool(rz > 0) and bool(pAp > 0)):
            it += 1
            continue
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return x, it


def _step(P: _Problem, lin, T, X, lam, rtol, max_iters):
    """The damped Schur step from (T, X): the trial point and |dx|."""
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
    D = Hpp_d - torch.zeros_like(Hpp_d).index_add_(0, ci, mm(mm(W, Hll_inv[li]), Wt))
    D_inv = _inverse(D)

    def matvec(v):
        xb = v.reshape(C, 6)
        u = mm(Hll_inv, by_lm(mm(Wt, xb[ci][..., None])[..., 0])[..., None])[..., 0]
        return (mm(Hpp_d, xb[..., None])[..., 0] - by_cam(mm(W, u[li][..., None])[..., 0])).reshape(-1)

    def precond(v):
        return mm(D_inv, v.reshape(C, 6)[..., None])[..., 0].reshape(-1)

    x, _ = pcg(matvec, precond, b, rtol, max_iters, guard=True)
    dxp = x.reshape(C, 6).clone()
    dxp[0] = 0
    dxl = mm(Hll_inv, (gl - by_lm(mm(Wt, dxp[ci][..., None])[..., 0]))[..., None])[..., 0]
    norm = torch.sqrt((dxp ** 2).sum() + (dxl ** 2).sum())
    return (mm(lie.se3_exp(dxp, mm), T), X + dxl), norm


def solve(problem: dict, config: dict, ar: Arith) -> dict:
    """The configuration's solve from the generator's start: the best
    point, its cost and the LM iterations run."""
    o, s = config["options"], config["solver"]
    if o["method"] != "lm":
        raise ValueError("the reference runs method 'lm' only")
    P = _Problem(problem, ar)
    T, X = ar.t(problem["poses_init"]), ar.t(problem["pts_init"])
    cost, lin = P.linearize(T, X)
    chi2 = float(cost)
    best = (T, X, chi2)
    lam = o["lambda_init"]
    it = 0
    history = []  # (accepted, cost after the iteration) an iteration
    for it in range(1, o["max_iters"] + 1):
        (Tt, Xt), norm = _step(P, lin, T, X, lam, s["pcg_rtol"], s["pcg_max_iters"])
        cost_t, lin_t = P.linearize(Tt, Xt)
        new, norm = float(cost_t), float(norm)
        accept = new < chi2
        prev = chi2
        if accept:
            T, X, lin, chi2 = Tt, Xt, lin_t, new
            lam = max(lam * o["lambda_down"], o["lambda_min"])
        else:
            lam = min(lam * o["lambda_up"], o["lambda_max"])
        del lin_t
        history.append((accept, chi2))
        if new < best[2]:
            best = (Tt, Xt, new)
        if (accept and norm < o["min_update_norm"]) or new < o["min_cost"] or (
                accept and not new < prev * o["min_cost_decrease"]):
            break
    return dict(poses=best[0], landmarks=best[1], chi2=best[2], iterations=it, history=history,
                first_cost=_first_cost(history))


def _first_cost(history) -> float:
    """The cost after the first accepted step."""
    return next((c for accepted, c in history if accepted), float("nan"))


def cost(problem: dict, answer: dict, ar: Arith) -> float:
    P = _Problem(problem, ar)
    return float(P.cost(ar.t(answer["poses"]), ar.t(answer["landmarks"])))


def distances(a: dict, b: dict):
    """The distance of every variable of a from b, in float64: each camera
    by the norm of the tangent of T_a T_b^-1, then each landmark by the norm
    of its difference."""
    Ta, Tb = a["poses"].to(torch.float64), b["poses"].to(torch.float64)
    xi = lie.se3_log(Ta @ lie.se3_inv(Tb))
    dl = a["landmarks"].to(torch.float64) - b["landmarks"].to(torch.float64)
    return torch.cat([torch.linalg.vector_norm(xi, dim=-1), torch.linalg.vector_norm(dl, dim=-1)])


def start(problem: dict) -> dict:
    return dict(poses=problem["poses_init"], landmarks=problem["pts_init"])
