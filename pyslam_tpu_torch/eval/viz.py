"""Trajectory visualization: top-down trajectory plots, segment-error plots
and per-pose / cumulative error-norm plots.

Counterpart of ``pyslam_tpu/eval/viz.py``: host matplotlib, imported when a
plot is made, over metrics computed on their device and read back once a
plot.
"""

from __future__ import annotations

import numpy as np
import torch


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class TrajectoryVisualizer:
    """Plots for one or more TrajectoryMetrics ({label: tm} or a single tm)."""

    def __init__(self, tm_dict):
        from .metrics import TrajectoryMetrics

        if isinstance(tm_dict, TrajectoryMetrics):
            tm_dict = {"est": tm_dict}
        self.tm_dict = dict(tm_dict)

    def _first(self):
        return next(iter(self.tm_dict.values()))

    @staticmethod
    def _finish(fig, outfile, plt):
        if outfile:
            fig.savefig(outfile, dpi=150, bbox_inches="tight")
            plt.close(fig)

    def plot_topdown(self, which_plane: str = "xy", outfile: str | None = None, **fig_kw):
        """Top-down (plane projection) of the ground truth and every estimate."""
        plt = _plt()
        axes = {"xy": (0, 1), "xz": (0, 2), "yz": (1, 2)}[which_plane]
        fig, ax = plt.subplots(**fig_kw)
        gt = _np(self._first().positions_gt)
        a = axes[0] % gt.shape[-1]
        b = axes[1] % gt.shape[-1]
        ax.plot(gt[:, a], gt[:, b], "k--", linewidth=1.5, label="Ground truth")
        for label, tm in self.tm_dict.items():
            p = _np(tm.positions_est)
            ax.plot(p[:, a], p[:, b], linewidth=1.0, label=label)
        ax.set_xlabel(which_plane[0] + " (m)")
        ax.set_ylabel(which_plane[1] + " (m)")
        ax.axis("equal")
        ax.legend()
        ax.grid(True, alpha=0.3)
        self._finish(fig, outfile, plt)
        return fig, ax

    def plot_segment_errors(self, segment_lengths, outfile: str | None = None, **fig_kw):
        """Mean translational / rotational error against segment length (KITTI)."""
        plt = _plt()
        fig, (ax_t, ax_r) = plt.subplots(1, 2, **{"figsize": (10, 4), **fig_kw})
        for label, tm in self.tm_dict.items():
            segs = tm.mean_segment_errors(segment_lengths, rot_unit="deg")
            if not len(segs):
                continue
            ax_t.plot(segs[:, 0], segs[:, 1] * 100.0, marker="o", label=label)
            ax_r.plot(segs[:, 0], segs[:, 2], marker="o", label=label)
        ax_t.set_xlabel("Segment length (m)")
        ax_t.set_ylabel("Translational error (%)")
        ax_r.set_xlabel("Segment length (m)")
        ax_r.set_ylabel("Rotational error (deg/m)")
        for ax in (ax_t, ax_r):
            ax.legend()
            ax.grid(True, alpha=0.3)
        self._finish(fig, outfile, plt)
        return fig, (ax_t, ax_r)

    def plot_norm_err(self, outfile: str | None = None, rel: bool = False, **fig_kw):
        """Per-pose translational / rotational error norms along the path."""
        plt = _plt()
        fig, (ax_t, ax_r) = plt.subplots(2, 1, sharex=True, **{"figsize": (8, 6), **fig_kw})
        for label, tm in self.tm_dict.items():
            trans, rot = (tm.rel_errors if rel else tm.traj_errors)("all")
            trans, rot = _np(trans), _np(rot)
            x = _np(tm.cum_dists())[: len(trans)]
            ax_t.plot(x, trans, label=label)
            ax_r.plot(x, np.degrees(rot), label=label)
        ax_t.set_ylabel("Trans err (m)")
        ax_r.set_ylabel("Rot err (deg)")
        ax_r.set_xlabel("Distance traveled (m)")
        for ax in (ax_t, ax_r):
            ax.legend()
            ax.grid(True, alpha=0.3)
        self._finish(fig, outfile, plt)
        return fig, (ax_t, ax_r)

    def plot_cum_norm_err(self, outfile: str | None = None, **fig_kw):
        """Cumulative error norms along the path."""
        plt = _plt()
        fig, (ax_t, ax_r) = plt.subplots(2, 1, sharex=True, **{"figsize": (8, 6), **fig_kw})
        for label, tm in self.tm_dict.items():
            trans, rot = tm.traj_errors("all")
            x = _np(tm.cum_dists())
            ax_t.plot(x, np.cumsum(_np(trans)), label=label)
            ax_r.plot(x, np.degrees(np.cumsum(_np(rot))), label=label)
        ax_t.set_ylabel("Cum. trans err (m)")
        ax_r.set_ylabel("Cum. rot err (deg)")
        ax_r.set_xlabel("Distance traveled (m)")
        for ax in (ax_t, ax_r):
            ax.legend()
            ax.grid(True, alpha=0.3)
        self._finish(fig, outfile, plt)
        return fig, (ax_t, ax_r)


__all__ = ["TrajectoryVisualizer"]
