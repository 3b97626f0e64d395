"""Trajectory error metrics.

Counterpart of ``pyslam_tpu/eval/metrics.py``: ``TrajectoryMetrics``, on
torch tensors on one device, with batched SE(2) / SE(3) log maps.

Error definitions (the reference's):
  * per-pose error:      xi_i  = log(T_gt_i^-1 * T_est_i)   (Twv convention)
  * relative-pose error: xi_ij = log((T_gt_i^-1 T_gt_j)^-1 (T_est_i^-1 T_est_j))
  * segment errors:      KITTI-style per-segment-length average translation /
    rotation error over all segments of the given path lengths
  * scalar summaries: endpoint, mean, RMS, cumulative norms and ATE / ARMSE

``saveas`` / ``loadfrom`` write and read the reference's payload (numpy
arrays and the convention, as a pickle or a ``.mat`` file), so a file
written by either package loads in the other.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from .._device import resolve_device
from ..lie import se2, se3


def _ops(dim: int):
    return se2 if dim == 2 else se3


def _stacked(Ts, dtype, device):
    """A stack of poses as one tensor on ``device``: a tensor as it is (no
    read to the host), else the poses (arrays, tensors, Lie objects)
    stacked on the host."""
    if not torch.is_tensor(Ts):
        Ts = np.stack([np.asarray(T.detach().cpu() if torch.is_tensor(T) else getattr(T, "mat", T)) for T in Ts])
    return torch.as_tensor(Ts, dtype=dtype).to(device)


class TrajectoryMetrics:
    """Ground-truth against estimated trajectory errors.

    Parameters
    ----------
    Twv_gt, Twv_est : (N, 4, 4) or (N, 3, 3) poses (arrays, tensors or lists).
    convention : 'Twv' (world <- vehicle, the default, the reference's) or
        'Tvw' (vehicle <- world; inverted on input).
    dtype : the tensors' dtype (default: the inputs' common dtype).
    device : where the poses live and the errors are computed (None:
        ``default_device()``).
    """

    def __init__(self, Twv_gt, Twv_est, convention: str = "Twv", dtype=None, device=None):
        self.device = resolve_device(device)
        Twv_gt, Twv_est = _stacked(Twv_gt, dtype, self.device), _stacked(Twv_est, dtype, self.device)
        if Twv_gt.shape != Twv_est.shape:
            raise ValueError("trajectory shapes differ")
        common = torch.promote_types(Twv_gt.dtype, Twv_est.dtype)
        Twv_gt, Twv_est = Twv_gt.to(common), Twv_est.to(common)
        self.dim = 2 if Twv_gt.shape[-1] == 3 else 3
        ops = _ops(self.dim)
        if convention == "Tvw":
            Twv_gt, Twv_est = ops.inv(Twv_gt), ops.inv(Twv_est)
        elif convention != "Twv":
            raise ValueError(f"unknown convention {convention!r}")
        self.convention = "Twv"
        self.Twv_gt = Twv_gt
        self.Twv_est = Twv_est
        self.num_poses = Twv_gt.shape[0]

    # ---- path geometry ----

    @property
    def positions_gt(self):
        return self.Twv_gt[:, : self.dim, -1]

    @property
    def positions_est(self):
        return self.Twv_est[:, : self.dim, -1]

    def cum_dists(self):
        """(N,) cumulative ground-truth path length."""
        steps = torch.linalg.norm(torch.diff(self.positions_gt, dim=0), dim=-1)
        return torch.cat([steps.new_zeros(1), torch.cumsum(steps, dim=0)])

    # ---- error vectors ----

    def error(self):
        """(N, dof) per-pose error log(T_gt^-1 * T_est); the translation
        components first."""
        ops = _ops(self.dim)
        return ops.log(ops.inv(self.Twv_gt) @ self.Twv_est)

    def _norms(self, xi):
        t = self.dim
        return torch.linalg.norm(xi[:, :t], dim=-1), torch.linalg.norm(xi[:, t:], dim=-1)

    def traj_errors(self, error_type: str = "all"):
        """Per-pose (trans_err, rot_err) norms; ``error_type`` selects
        'trans' | 'rot' | 'all'."""
        return self._select(*self._norms(self.error()), error_type)

    def rel_errors(self, error_type: str = "all", delta: int = 1):
        """Relative-pose (odometry) errors between poses i and i + delta."""
        ops = _ops(self.dim)
        Tg, Te = self.Twv_gt, self.Twv_est
        rel_gt = ops.inv(Tg[:-delta]) @ Tg[delta:]
        rel_est = ops.inv(Te[:-delta]) @ Te[delta:]
        return self._select(*self._norms(ops.log(ops.inv(rel_gt) @ rel_est)), error_type)

    @staticmethod
    def _select(trans, rot, error_type):
        if error_type == "trans":
            return trans
        if error_type == "rot":
            return rot
        return trans, rot

    # ---- scalar summaries ----

    def endpoint_error(self):
        """Translational error at the final pose."""
        xi = self.error()[-1]
        return torch.linalg.norm(xi[: self.dim])

    def mean_err(self, error_type: str = "all"):
        trans, rot = self.traj_errors("all")
        return self._select(torch.mean(trans), torch.mean(rot), error_type)

    def rms_err(self, error_type: str = "all"):
        trans, rot = self.traj_errors("all")
        return self._select(torch.sqrt(torch.mean(trans**2)), torch.sqrt(torch.mean(rot**2)), error_type)

    def cum_err(self, error_type: str = "all"):
        trans, rot = self.traj_errors("all")
        return self._select(torch.sum(trans), torch.sum(rot), error_type)

    def armse(self, error_type: str = "all"):
        """Absolute RMSE without alignment: position RMSE (the common ATE)
        and rotation RMSE."""
        dp = self.positions_est - self.positions_gt
        trans = torch.sqrt(torch.mean(torch.sum(dp**2, dim=-1)))
        _, rot_err = self.traj_errors("all")
        return self._select(trans, torch.sqrt(torch.mean(rot_err**2)), error_type)

    # ---- trajectory alignment ----

    def align(self, method: str = "se3") -> "TrajectoryMetrics":
        """A new TrajectoryMetrics with the estimate aligned to the ground
        truth by the closed-form Umeyama transform over positions:
        'se3' / 'se2' rigid, 'sim3' / 'sim2' with scale (monocular
        trajectories), 'none' returns self. The transform is kept in
        ``alignment`` (rotation, translation, scale)."""
        method = method.lower()
        if method in ("none",):
            return self
        with_scale = method in ("sim3", "sim2")
        if method not in ("se3", "se2", "sim3", "sim2"):
            raise ValueError(f"unknown alignment {method!r}")
        d = self.dim
        P = self.positions_gt  # (N, d) target
        Q = self.positions_est  # (N, d) source
        mu_p = torch.mean(P, dim=0)
        mu_q = torch.mean(Q, dim=0)
        Pc, Qc = P - mu_p, Q - mu_q
        Sigma = (Pc.T @ Qc) / self.num_poses  # (d, d)
        U, D, Vt = torch.linalg.svd(Sigma)
        s = torch.cat([torch.ones(d - 1, dtype=Sigma.dtype, device=Sigma.device),
                       torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))[None]])
        R = (U * s[None, :]) @ Vt
        var_q = torch.mean(torch.sum(Qc * Qc, dim=-1))
        c = torch.sum(D * s) / var_q if with_scale else torch.ones((), dtype=D.dtype, device=D.device)
        t = mu_p - c * (R @ mu_q)
        # positions p -> c R p + t, rotations -> R R_est (unscaled)
        R_est = self.Twv_est[:, :d, :d]
        p_est = self.Twv_est[:, :d, -1]
        Twv_new = torch.zeros_like(self.Twv_est)
        Twv_new[:, -1, -1] = 1.0
        Twv_new[:, :d, :d] = R[None] @ R_est
        Twv_new[:, :d, -1] = c * torch.einsum("ij,nj->ni", R, p_est) + t
        out = TrajectoryMetrics(self.Twv_gt, Twv_new, device=self.device)
        out.alignment = dict(method=method, rotation=R, translation=t, scale=c)
        return out

    # ---- KITTI-style segment errors ----

    def segment_errors(self, segment_lengths, rot_unit: str = "rad"):
        """For each start pose and each segment length L, the pose where the
        cumulative ground-truth path length exceeds L; the relative-pose
        error there, normalized by L. Returns (K, 3) numpy rows [length,
        trans_err / L, rot_err / L] over all valid (start, length) pairs."""
        ops = _ops(self.dim)
        dists = self.cum_dists().cpu().numpy()
        starts, ends, lens = [], [], []
        for L in segment_lengths:
            end_idx = np.searchsorted(dists, dists + L)
            valid = end_idx < len(dists)
            s = np.nonzero(valid)[0]
            starts.append(s)
            ends.append(end_idx[valid])
            lens.append(np.full(len(s), float(L)))
        if not starts or sum(len(s) for s in starts) == 0:
            return np.zeros((0, 3))
        s = torch.as_tensor(np.concatenate(starts), device=self.device)
        e = torch.as_tensor(np.concatenate(ends), device=self.device)
        L = np.concatenate(lens)
        Tg, Te = self.Twv_gt, self.Twv_est
        rel_gt = ops.inv(Tg[s]) @ Tg[e]
        rel_est = ops.inv(Te[s]) @ Te[e]
        xi = ops.log(ops.inv(rel_gt) @ rel_est).cpu().numpy()
        t = self.dim
        trans = np.linalg.norm(xi[:, :t], axis=-1) / L
        rot = np.linalg.norm(xi[:, t:], axis=-1) / L
        if rot_unit == "deg":
            rot = np.degrees(rot)
        return np.stack([L, trans, rot], axis=-1)

    def mean_segment_errors(self, segment_lengths, rot_unit: str = "rad"):
        """Average segment errors per length: (len(segment_lengths), 3)."""
        segs = self.segment_errors(segment_lengths, rot_unit)
        out = []
        for L in segment_lengths:
            sel = segs[segs[:, 0] == float(L)]
            if len(sel):
                out.append([float(L), sel[:, 1].mean(), sel[:, 2].mean()])
        return np.asarray(out)

    # ---- serialization (the reference's files) ----

    def saveas(self, path: str):
        payload = {
            "Twv_gt": self.Twv_gt.cpu().numpy(),
            "Twv_est": self.Twv_est.cpu().numpy(),
            "convention": self.convention,
        }
        if path.endswith(".mat"):
            from scipy.io import savemat

            savemat(path, payload)
        else:
            with open(path, "wb") as f:
                pickle.dump(payload, f)

    @classmethod
    def loadfrom(cls, path: str, device=None) -> "TrajectoryMetrics":
        if path.endswith(".mat"):
            from scipy.io import loadmat

            payload = loadmat(path)
            conv = str(np.squeeze(payload["convention"]))
        else:
            with open(path, "rb") as f:
                payload = pickle.load(f)
            conv = payload["convention"]
        return cls(np.asarray(payload["Twv_gt"]), np.asarray(payload["Twv_est"]), convention=conv, device=device)


__all__ = ["TrajectoryMetrics"]
