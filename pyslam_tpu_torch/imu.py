"""IMU preintegration and the preintegrated inertial factor (VIO).

Counterpart of ``pyslam_tpu/imu.py`` (Forster et al., "On-Manifold
Preintegration", arXiv 1512.02363):

* ``preintegrate`` integrates the gyro / accelerometer samples between two
  keyframes into one relative-motion constraint (dR, dv, dp), its
  first-order bias Jacobians and its 9x9 noise covariance, with the
  reference's signature and numbers.  ``vio_graph`` runs the same
  recursion once over every interval of a trajectory, stacked on a
  leading axis (``_preintegrate_batched``), so that the launches scale with
  the samples of one interval and not with the number of intervals.
  Intervals of unequal length are padded with ``dt = 0`` samples, an exact
  no-op of the recursion (E = I, B = 0).
* ``imu_preintegrated``: the Forster residual over (T_i, T_j, v_i, v_j,
  b_i) with analytic Jacobians in the left-perturbation convention.
* ``between_euclidean``: the bias random-walk factor b_j - b_i.

Conventions: poses are T_b_w (world -> body): the rotation block A = R_bw
maps world vectors into the body frame, and the body position in the
world is p = -A^T t.  Velocities v (world frame) and biases b = [b_gyro
(3), b_accel (3)] are euclidean blocks.

Residual (9,) = [r_dR, r_dv, r_dp], with db = b_i - b_lin:
  r_dR = Log( (dR Exp(J_Rg db_g))^T A_i A_j^T )
  r_dv = A_i (v_j - v_i - g dt)                      - (dv + J_vg db_g + J_va db_a)
  r_dp = A_i (p_j - p_i - v_i dt - 0.5 g dt^2)       - (dp + J_pg db_g + J_pa db_a)
premultiplied by the preintegration sqrt information.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ._device import resolve_device
from .graph.core import register_factor
from .lie import so3

GRAVITY = np.array([0.0, 0.0, -9.81])


@dataclasses.dataclass(frozen=True)
class ImuParams:
    """Continuous-time IMU noise densities (units: rad/s/sqrt(Hz) etc.)."""

    sigma_gyro: float = 1.7e-4
    sigma_accel: float = 2.0e-3
    sigma_gyro_walk: float = 2.0e-5
    sigma_accel_walk: float = 3.0e-3
    gravity: tuple = (0.0, 0.0, -9.81)


class PreintegratedImu(NamedTuple):
    """One keyframe-to-keyframe preintegrated constraint (tensors; from
    ``_preintegrate_batched`` every field carries a leading interval
    axis)."""

    dR: torch.Tensor  # (3, 3)
    dv: torch.Tensor  # (3,)
    dp: torch.Tensor  # (3,)
    J_Rg: torch.Tensor  # (3, 3)  d dR / d b_gyro
    J_vg: torch.Tensor  # (3, 3)
    J_va: torch.Tensor  # (3, 3)
    J_pg: torch.Tensor  # (3, 3)
    J_pa: torch.Tensor  # (3, 3)
    cov: torch.Tensor  # (9, 9)  order [dR, dv, dp]
    dt: torch.Tensor  # ()
    b_lin: torch.Tensor  # (6,)  bias linearization point [b_g, b_a]


def _bmv(A, v):
    return (A @ v[..., None])[..., 0]


def _preintegrate_batched(omega, accel, dts, b_g, b_a, sigma_gyro, sigma_accel):
    """The preintegration recursion over B intervals at once.

    omega, accel: (B, K, 3); dts: (B, K); b_g, b_a: (B, 3); all of one
    dtype on one device.  The discrete propagation (Forster eq. 35-36), the
    bias Jacobians (appendix C) and the covariance run step by step over
    the sample axis; the per-step discrete noise is sigma^2 / dt.  A step
    with dt = 0 changes nothing.  Returns a PreintegratedImu with a
    leading B axis; ``dt`` is the sum of each interval's steps, in step
    order."""
    B, K = dts.shape
    dtype, device = omega.dtype, omega.device
    eye3 = torch.eye(3, dtype=dtype, device=device).expand(B, 3, 3)
    Z3 = torch.zeros((B, 3, 3), dtype=dtype, device=device)
    dR = eye3.clone()
    dv = torch.zeros((B, 3), dtype=dtype, device=device)
    dp = torch.zeros_like(dv)
    J_Rg = J_vg = J_va = J_pg = J_pa = Z3
    cov = torch.zeros((B, 9, 9), dtype=dtype, device=device)
    t_sum = torch.zeros(B, dtype=dtype, device=device)
    q_gyro, q_accel = sigma_gyro**2, sigma_accel**2
    for k in range(K):
        w, a, dt = omega[:, k], accel[:, k], dts[:, k]
        dt1, dt2 = dt[:, None], dt[:, None, None]
        wdt = (w - b_g) * dt1
        ah = a - b_a
        E = so3.exp(wdt)
        Jr = so3.left_jacobian(-wdt)  # right Jacobian J_r(wdt) = J_l(-wdt)
        Ra = _bmv(dR, ah)
        ax = so3.wedge(ah)
        dR_ax = dR @ ax

        dp_n = dp + dv * dt1 + _bmv(0.5 * dR, ah) * dt1 * dt1
        dv_n = dv + Ra * dt1
        dR_n = dR @ E

        # bias Jacobians (Forster appendix C)
        J_pg_n = J_pg + J_vg * dt2 - (0.5 * dR) @ ax @ J_Rg * dt2 * dt2
        J_pa_n = J_pa + J_va * dt2 - 0.5 * dR * dt2 * dt2
        J_vg_n = J_vg - dR_ax @ J_Rg * dt2
        J_va_n = J_va - dR * dt2
        J_Rg_n = E.transpose(-1, -2) @ J_Rg - Jr * dt2

        # covariance propagation, state order [dR, dv, dp]
        A = torch.cat(
            [
                torch.cat([E.transpose(-1, -2), Z3, Z3], dim=-1),
                torch.cat([(-dR) @ ax * dt2, eye3, Z3], dim=-1),
                torch.cat([(-0.5 * dR) @ ax * dt2 * dt2, eye3 * dt2, eye3], dim=-1),
            ],
            dim=-2,
        )
        Bm = torch.cat(
            [
                torch.cat([Jr * dt2, Z3], dim=-1),
                torch.cat([Z3, dR * dt2], dim=-1),
                torch.cat([Z3, 0.5 * dR * dt2 * dt2], dim=-1),
            ],
            dim=-2,
        )
        # continuous-density -> discrete variance: sigma^2 / dt
        dt_floor = torch.clamp(dt1, min=1e-12)
        qd = torch.cat([(q_gyro / dt_floor).expand(B, 3), (q_accel / dt_floor).expand(B, 3)], dim=-1)
        cov = A @ cov @ A.transpose(-1, -2) + (Bm * qd[:, None, :]) @ Bm.transpose(-1, -2)
        dR, dv, dp = dR_n, dv_n, dp_n
        J_Rg, J_vg, J_va, J_pg, J_pa = J_Rg_n, J_vg_n, J_va_n, J_pg_n, J_pa_n
        t_sum = t_sum + dt
    return PreintegratedImu(dR, dv, dp, J_Rg, J_vg, J_va, J_pg, J_pa, cov, t_sum, torch.cat([b_g, b_a], dim=-1))


def _as_tensor(x, dtype, device):
    return x.to(dtype=dtype, device=device) if torch.is_tensor(x) else torch.tensor(np.asarray(x), dtype=dtype).to(device)


def preintegrate(omega, accel, dts, b_gyro, b_accel, sigma_gyro=1.7e-4, sigma_accel=2.0e-3, device=None):
    """Integrate K IMU samples into a PreintegratedImu.

    omega, accel: (K, 3) body-frame angular rate / specific force
    dts:          (K,) sample intervals
    b_gyro/b_accel: (3,) bias linearization points

    Computed in the dtype of ``omega`` (a tensor's, or float64 for numpy
    input) on ``omega``'s device when it is a tensor, else on ``device``
    (None: the package's default, the CUDA card)."""
    if torch.is_tensor(omega):
        dtype, device = omega.dtype, omega.device
    else:
        dtype, device = torch.as_tensor(np.asarray(omega)).dtype, resolve_device(device)
    t = [_as_tensor(x, dtype, device) for x in (omega, accel, dts, b_gyro, b_accel)]
    pim = _preintegrate_batched(t[0][None], t[1][None], t[2][None], t[3][None], t[4][None], sigma_gyro, sigma_accel)
    return PreintegratedImu(*(f[0] for f in pim))


def _sqrt_info_host(cov, jitter):
    """(B, 9, 9) lower-triangular sqrt informations L^-1 (cov = L L^T) of
    (B, 9, 9) float64 host covariances, each with its own relative
    jitter."""
    diag_max = np.max(np.diagonal(cov, axis1=-2, axis2=-1), axis=-1)
    eps = jitter * np.maximum(diag_max, 1e-300)
    cov = 0.5 * (cov + np.swapaxes(cov, -1, -2)) + eps[:, None, None] * np.eye(9)
    return np.linalg.inv(np.linalg.cholesky(cov))


def sqrt_info_of(pim: PreintegratedImu, jitter: float = 1e-12):
    """(9, 9) lower-triangular sqrt information from the preintegrated
    covariance: L^-1 with cov = L L^T, so (L^-1)^T (L^-1) = cov^-1, by a
    host f64 Cholesky (a one-time per-factor setup).  The jitter is
    relative to the covariance scale.  Returns a numpy array in the dtype
    of ``pim.dR``."""
    cov = pim.cov.detach().cpu().numpy().astype(np.float64)
    S = _sqrt_info_host(cov[None], jitter)[0]
    return S.astype(pim.dR.detach().cpu().numpy().dtype)


@register_factor("imu_preintegrated")
def imu_preintegrated(data, T_i, T_j, v_i, v_j, b_i, compute_jacobians=True):
    """Preintegrated inertial factor over (pose_i, pose_j, vel_i, vel_j,
    bias_i).  data keys: dR dv dp J_Rg J_vg J_va J_pg J_pa (F,3,3)/(F,3),
    b_lin (F,6), dt (F,), sqrt_info (F,9,9), gravity (F,3)."""
    A_i = T_i[..., :3, :3]  # R_bw of keyframe i
    A_j = T_j[..., :3, :3]
    A_iT = A_i.transpose(-1, -2)
    p_i = -_bmv(A_iT, T_i[..., :3, 3])  # body position in the world
    p_j = -_bmv(A_j.transpose(-1, -2), T_j[..., :3, 3])
    dt = data["dt"][..., None]
    grav = data["gravity"]
    db = b_i - data["b_lin"]
    db_g, db_a = db[..., :3], db[..., 3:]

    dR_t = data["dR"] @ so3.exp(_bmv(data["J_Rg"], db_g))
    dv_t = data["dv"] + _bmv(data["J_vg"], db_g) + _bmv(data["J_va"], db_a)
    dp_t = data["dp"] + _bmv(data["J_pg"], db_g) + _bmv(data["J_pa"], db_a)

    A_ij = A_i @ A_j.transpose(-1, -2)
    r_R = so3.log(dR_t.transpose(-1, -2) @ A_ij)
    w_v = v_j - v_i - grav * dt
    r_v = _bmv(A_i, w_v) - dv_t
    u_p = p_j - p_i - v_i * dt - 0.5 * grav * dt * dt
    r_p = _bmv(A_i, u_p) - dp_t

    S = data["sqrt_info"]
    r = _bmv(S, torch.cat([r_R, r_v, r_p], dim=-1))
    if not compute_jacobians:
        return r, None

    Z = torch.zeros_like(A_i)
    eye = torch.eye(3, dtype=A_i.dtype, device=A_i.device).expand_as(A_i)
    Jl_inv = so3.inv_left_jacobian(r_R)
    Jr_inv_neg = so3.inv_left_jacobian(-r_R)  # J_r^-1(r) = J_l^-1(-r)

    # pose i (left perturbation of T_i = T_b_w): d p_i = -A_i^T rho
    J_Ti = torch.cat(
        [
            torch.cat([Z, Jl_inv @ dR_t.transpose(-1, -2)], dim=-1),
            torch.cat([Z, -so3.wedge(_bmv(A_i, w_v))], dim=-1),
            torch.cat([eye, -so3.wedge(_bmv(A_i, u_p))], dim=-1),
        ],
        dim=-2,
    )  # (F, 9, 6) over [rho, phi]
    J_Tj = torch.cat(
        [
            torch.cat([Z, -Jr_inv_neg], dim=-1),
            torch.cat([Z, Z], dim=-1),
            torch.cat([-A_ij, Z], dim=-1),
        ],
        dim=-2,
    )
    J_vi = torch.cat([Z, -A_i, -A_i * dt[..., None]], dim=-2)
    J_vj = torch.cat([Z, A_i, Z], dim=-2)
    # bias i: W = J_r(J_Rg db_g) J_Rg for the rotation row
    W = so3.left_jacobian(-_bmv(data["J_Rg"], db_g)) @ data["J_Rg"]
    J_bg = torch.cat([-(Jl_inv @ W), -data["J_vg"], -data["J_pg"]], dim=-2)
    J_ba = torch.cat([Z, -data["J_va"], -data["J_pa"]], dim=-2)
    J_bi = torch.cat([J_bg, J_ba], dim=-1)  # (F, 9, 6)
    return r, tuple(S @ J for J in (J_Ti, J_Tj, J_vi, J_vj, J_bi))


@register_factor("between_euclidean")
def between_euclidean(data, x_i, x_j, compute_jacobians=True):
    """Euclidean between factor r = sqrt_info (x_j - x_i - delta): the bias
    random walk (delta = 0) and any linear relative constraint."""
    d = x_i.reshape(x_i.shape[0], -1)
    r = _bmv(data["sqrt_info"], x_j.reshape(d.shape) - d - data["delta"])
    if not compute_jacobians:
        return r, None
    S = data["sqrt_info"]
    return r, (-S, S)


_PIM_DATA = ("dR", "dv", "dp", "J_Rg", "J_vg", "J_va", "J_pg", "J_pa", "b_lin", "dt")


def _padded_intervals(omega, accel, dts):
    """Per-interval sample arrays (an (N-1, K, ...) array, or lists of
    arrays of unequal length, as ``io.euroc.segment_imu`` gives them) as
    (N-1, K_max, ...) float64 arrays padded with dt = 0 samples."""
    lengths = [len(np.asarray(d)) for d in dts]
    n, K = len(lengths), max(lengths)
    out = np.zeros((n, K, 3)), np.zeros((n, K, 3)), np.zeros((n, K))
    for i, (w, a, d) in enumerate(zip(omega, accel, dts)):
        k = lengths[i]
        out[0][i, :k], out[1][i, :k], out[2][i, :k] = w, a, d
    return out


def vio_graph(
    data,
    T_prior,
    pose_prior_sqrt_info,
    params: ImuParams = ImuParams(),
    bias_walk_sigma: float = 1e-3,
    bias_prior_sigma: float = 0.5,
    prior_indices=None,
    T_init=None,
    v_init=None,
    b_init=None,
    dtype=torch.float64,
    device=None,
):
    """Build a visual-inertial smoothing FactorGraph from ``synth.ImuData``
    (or any object with its fields; ``omega`` / ``accel`` / ``dts`` may be
    lists of per-interval arrays of unequal length, as
    ``io.euroc.segment_imu`` gives them).

    Structure (the classic VIO fixed-window graph): per-keyframe states
    (pose T_b_w, world velocity, 6-dof bias), one preintegrated IMU factor
    per interval (integrated at zero bias in float64, every interval in one
    batched recursion on ``device``; online bias correction rides the
    factor's first-order bias Jacobians), a bias random-walk chain, unary
    pose priors standing in for the visual solution (``T_prior`` +
    ``pose_prior_sqrt_info``), and a weak prior pinning the first bias.
    The covariances of all intervals come to the host in one read for
    their f64 Cholesky.  Tensors in ``dtype`` on ``device`` (None: the
    package's default, the CUDA card)."""
    from .graph.core import FactorBatch, FactorGraph, VariableBlock
    from .losses import L2Loss

    device = resolve_device(device)
    f64 = torch.float64
    N = data.T_gt.shape[0]
    omega, accel, dts = _padded_intervals(data.omega, data.accel, data.dts)
    z = torch.zeros((N - 1, 3), dtype=f64, device=device)
    pim = _preintegrate_batched(*(_as_tensor(x, f64, device) for x in (omega, accel, dts)), z, z,
                                params.sigma_gyro, params.sigma_accel)
    S = _sqrt_info_host(pim.cov.cpu().numpy(), 1e-12)

    def t(a):
        return _as_tensor(a, dtype, device)

    imu_data = {k: getattr(pim, k).to(dtype) for k in _PIM_DATA}
    imu_data["sqrt_info"] = t(S)
    imu_data["gravity"] = t(np.broadcast_to(np.asarray(params.gravity, np.float64), (N - 1, 3)))
    interval_s = np.array([np.sum(np.asarray(d)) for d in data.dts])

    blocks = {
        "poses": VariableBlock.create("se3", t(data.T_gt if T_init is None else T_init)),
        "vels": VariableBlock.create("euclidean", t(data.v_gt if v_init is None else v_init)),
        "biases": VariableBlock.create("euclidean", t(np.zeros((N, 6)) if b_init is None else b_init)),
    }
    ii = np.arange(N - 1, dtype=np.int32)
    jj = ii + 1
    n_prior = np.asarray(T_prior).shape[0]
    batches = [
        FactorBatch.create(
            "imu_preintegrated",
            slots=("poses", "poses", "vels", "vels", "biases"),
            indices=(ii, jj, ii, jj, ii),
            data=imu_data,
            loss=L2Loss(),
        ),
        FactorBatch.create(
            "between_euclidean",
            slots=("biases", "biases"),
            indices=(ii, jj),
            data={
                "delta": torch.zeros((N - 1, 6), dtype=dtype, device=device),
                "sqrt_info": t(np.eye(6) / (bias_walk_sigma * np.sqrt(interval_s))[:, None, None]
                               * np.ones((N - 1, 1, 1))),
            },
            loss=L2Loss(),
        ),
        FactorBatch.create(
            "prior_se3",
            slots=("poses",),
            indices=(np.arange(N, dtype=np.int32) if prior_indices is None else np.asarray(prior_indices, np.int32),),
            data={
                "T_obs": t(T_prior),
                "sqrt_info": t(np.broadcast_to(pose_prior_sqrt_info, (n_prior, 6, 6))),
            },
            loss=L2Loss(),
        ),
        FactorBatch.create(
            "prior_euclidean",
            slots=("biases",),
            indices=(np.zeros(1, np.int32),),
            data={"obs": torch.zeros((1, 6), dtype=dtype, device=device), "sqrt_info": t(np.eye(6)[None] / bias_prior_sigma)},
            loss=L2Loss(),
        ),
    ]
    return FactorGraph(blocks, batches)


__all__ = [
    "GRAVITY",
    "ImuParams",
    "PreintegratedImu",
    "preintegrate",
    "sqrt_info_of",
    "vio_graph",
]
