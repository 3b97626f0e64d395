"""Plain reference of SE(3) pose-graph optimization: Levenberg-Marquardt
with block-Jacobi preconditioned conjugate gradients on the sparse normal
equations (Kuemmerle et al., "g2o: A General Framework for Graph
Optimization", ICRA 2011; the sphere2500 problem).

Plain PyTorch over the generator's tensors: no kernel, plan or value of
the program under test.  The same problem and algorithm as the
configuration states:

* residual r = S log(T_j T_i^-1 T_obs^-1) of every edge (S the square root
  of its information), cost 1/2 sum r^2; pose 0 fixed;
* tangents [rho, phi], updates exp(dx) T; the Jacobians are the derivatives
  of that residual along the six generators of either pose, taken by
  forward-mode differentiation of the logarithm;
* Marquardt damping D_ii += lam max(diag(D_ii), 1e-12) of every diagonal
  block; PCG from 0 under the inverse diagonal blocks, stopped before an
  iteration where |r| <= rtol |b| or after ``pcg_max_iters``;
* the trial point linearized whole: accepted where its cost is below the
  current one (lam / lambda_down), else lam * lambda_up; stop on a small
  accepted update, a cost below ``min_cost``, or an accepted step that
  lowers the cost by less than the factor ``min_cost_decrease``; the best
  point is returned."""

from __future__ import annotations

import torch

from .. import lie
from ..arith import Arith
from .ba_schur_lm import _damp, _first_cost, pcg


class _Problem:
    def __init__(self, problem: dict, ar: Arith):
        self.ar = ar
        self.ei, self.ej = problem["edges_i"], problem["edges_j"]
        self.T_obs_inv = lie.se3_inv(ar.t(problem["T_meas"]), ar.mm)
        self.S = ar.t(problem["sqrt_info"])
        self.n = problem["poses_init"].shape[0]
        self.G = lie.generators(ar.dtype, self.S.device)

    def error(self, T):
        """M = T_j T_i^-1 T_obs^-1 of every edge, and T_j T_i^-1."""
        mm = self.ar.mm
        rel = mm(T[self.ej], lie.se3_inv(T[self.ei], mm))
        return mm(rel, self.T_obs_inv), rel

    def residual(self, M):
        return self.ar.mm(self.S, lie.se3_log(M, self.ar.mm)[..., None])[..., 0]

    def cost(self, T):
        return 0.5 * (self.residual(self.error(T)[0]) ** 2).sum()

    def linearize(self, T):
        mm = self.ar.mm
        M, rel = self.error(T)
        r = self.residual(M)

        def log(m):
            return lie.se3_log(m, mm)

        cols_i, cols_j = [], []
        for k in range(6):
            Gk = self.G[k]
            # d/d eps of exp(eps G) T_j ... and of ... (exp(eps G) T_i)^-1 ...
            cols_j.append(torch.func.jvp(log, (M,), (mm(Gk.expand_as(M), M),))[1])
            cols_i.append(torch.func.jvp(log, (M,), (-mm(mm(rel, Gk.expand_as(M)), self.T_obs_inv),))[1])
        Ji = mm(self.S, torch.stack(cols_i, -1))
        Jj = mm(self.S, torch.stack(cols_j, -1))
        Jit, Jjt = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
        dt, dev = r.dtype, r.device
        Hd = torch.zeros(self.n, 6, 6, dtype=dt, device=dev)
        Hd.index_add_(0, self.ei, mm(Jit, Ji)).index_add_(0, self.ej, mm(Jjt, Jj))
        Hod = mm(Jit, Jj)  # the (i, j) block of every edge
        g = torch.zeros(self.n, 6, dtype=dt, device=dev)
        g.index_add_(0, self.ei, -mm(Jit, r[..., None])[..., 0]).index_add_(0, self.ej, -mm(Jjt, r[..., None])[..., 0])
        # pose 0 fixed: its block the identity, its gradient and couplings 0
        Hd[0] = torch.eye(6, dtype=dt, device=dev)
        g[0] = 0
        Hod[(self.ei == 0) | (self.ej == 0)] = 0
        return 0.5 * (r ** 2).sum(), (Hd, Hod, g)


def _step(P: _Problem, lin, T, lam, rtol, max_iters):
    mm = P.ar.mm
    Hd, Hod, g = lin
    D = _damp(Hd, lam)
    D_inv = torch.linalg.inv(D)
    Hodt = Hod.transpose(-1, -2)
    ei, ej = P.ei, P.ej

    def matvec(v):
        x = v.reshape(P.n, 6)
        y = mm(D, x[..., None])[..., 0]
        y = y.index_add(0, ei, mm(Hod, x[ej][..., None])[..., 0]).index_add(0, ej, mm(Hodt, x[ei][..., None])[..., 0])
        return y.reshape(-1)

    def precond(v):
        return mm(D_inv, v.reshape(P.n, 6)[..., None])[..., 0].reshape(-1)

    x, _ = pcg(matvec, precond, g.reshape(-1), rtol, max_iters, guard=False)
    dx = x.reshape(P.n, 6).clone()
    dx[0] = 0
    return mm(lie.se3_exp(dx, mm), T), torch.sqrt((dx ** 2).sum())


def solve(problem: dict, config: dict, ar: Arith) -> dict:
    o, s = config["options"], config["solver"]
    if o["method"] != "lm":
        raise ValueError("the reference runs method 'lm' only")
    P = _Problem(problem, ar)
    T = ar.t(problem["poses_init"])
    cost, lin = P.linearize(T)
    chi2 = float(cost)
    best = (T, chi2)
    lam = o["lambda_init"]
    it = 0
    history = []  # (accepted, cost after the iteration) an iteration
    for it in range(1, o["max_iters"] + 1):
        Tt, norm = _step(P, lin, T, lam, s["pcg_rtol"], s["pcg_max_iters"])
        cost_t, lin_t = P.linearize(Tt)
        new, norm = float(cost_t), float(norm)
        accept = new < chi2
        prev = chi2
        if accept:
            T, lin, chi2 = Tt, lin_t, new
            lam = max(lam * o["lambda_down"], o["lambda_min"])
        else:
            lam = min(lam * o["lambda_up"], o["lambda_max"])
        del lin_t
        history.append((accept, chi2))
        if new < best[1]:
            best = (Tt, new)
        if (accept and norm < o["min_update_norm"]) or new < o["min_cost"] or (
                accept and not new < prev * o["min_cost_decrease"]):
            break
    return dict(poses=best[0], chi2=best[1], iterations=it, history=history, first_cost=_first_cost(history))


def cost(problem: dict, answer: dict, ar: Arith) -> float:
    return float(_Problem(problem, ar).cost(ar.t(answer["poses"])))


def distances(a: dict, b: dict):
    """The distance of every pose of a from b: the norm of the tangent of
    T_a T_b^-1, in float64."""
    Ta, Tb = a["poses"].to(torch.float64), b["poses"].to(torch.float64)
    return torch.linalg.vector_norm(lie.se3_log(Ta @ lie.se3_inv(Tb)), dim=-1)


def start(problem: dict) -> dict:
    return dict(poses=problem["poses_init"])
