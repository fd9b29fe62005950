"""Mesh and energy plots (port of ``mmadmm_tpu/harness/plotting.py``):
the reference's ``plot.py`` modes (``:16-332``), mesh wireframe (2D),
surface/boundary (3D), energy-decrease comparison, scaling curves.
Matplotlib (Agg) only, imported inside the functions (``_plt``), so that
nothing else of the port needs it; arrays may be NumPy arrays or tensors
on any device. Every function returns the output path.
"""

from __future__ import annotations

import os

import numpy as np


def _np(a) -> np.ndarray:
    """A NumPy copy of an array or a tensor (on any device)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_mesh_2d(X, F, out_path: str, title: str | None = None):
    """Triangle wireframe (plot.py mode 0)."""
    plt = _plt()
    X = _np(X)
    F = _np(F)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.triplot(X[:, 0], X[:, 1], F[:, :3], lw=0.3, color="#1f77b4")
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_mesh_3d_boundary(X, F, out_path: str, title: str | None = None):
    """Boundary faces of a tet mesh (plot.py mode 5-ish)."""
    plt = _plt()
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    X = _np(X)
    F = _np(F)
    # boundary triangles = faces appearing in exactly one tet
    faces = np.concatenate(
        [F[:, [0, 1, 2]], F[:, [0, 1, 3]], F[:, [0, 2, 3]], F[:, [1, 2, 3]]]
    )
    key = np.sort(faces, axis=1)
    _, idx, cnt = np.unique(key, axis=0, return_index=True, return_counts=True)
    bfaces = faces[idx[cnt == 1]]
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    ax.add_collection3d(
        Poly3DCollection(X[bfaces], alpha=0.5, edgecolor="k", linewidths=0.1)
    )
    ax.set_xlim(X[:, 0].min(), X[:, 0].max())
    ax.set_ylim(X[:, 1].min(), X[:, 1].max())
    ax.set_zlim(X[:, 2].min(), X[:, 2].max())
    if title:
        ax.set_title(title)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_energy_decrease(traces: dict, out_path: str, title: str | None = None):
    """Energy-vs-time comparison across methods
    (experiments.py:209-283). ``traces``: label -> (t, Ih) arrays."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 5))
    for label, (t, ih) in traces.items():
        ax.plot(_np(t), _np(ih), label=label, lw=1.2)
    ax.set_xlabel("wall time (s)")
    ax.set_ylabel(r"$I_h$")
    ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_mesh_animation(frames, F, out_path: str, fps: int = 5):
    """GIF of mesh evolution (plot.py mode 4). ``frames``: list of X
    arrays."""
    plt = _plt()
    from matplotlib.animation import PillowWriter

    F = _np(F)
    fig, ax = plt.subplots(figsize=(5, 5))
    writer = PillowWriter(fps=fps)
    with writer.saving(fig, out_path, dpi=100):
        for X in frames:
            X = _np(X)
            ax.clear()
            ax.triplot(X[:, 0], X[:, 1], F[:, :3], lw=0.3, color="#1f77b4")
            ax.set_aspect("equal")
            writer.grab_frame()
    plt.close(fig)
    return out_path


def plot_monitor_contour(grid_values, out_path: str, entry=0,
                         title: str | None = None):
    """Contour of one monitor-tensor entry over the background grid
    (plot.py grid mode). ``grid_values``: [ny+1, nx+1, D*D]."""
    plt = _plt()
    v = _np(grid_values)[..., entry]
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.contourf(v, levels=20)
    fig.colorbar(im, ax=ax)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_time_vs_simplices(scale_results: dict, out_path: str,
                           title: str | None = None):
    """Wall time vs problem size, one curve per method — the reference's
    ``plot_single_thread_increase`` (experiments.py:543-606, log-log time
    vs #simplices). ``scale_results`` is ``run_grid_scale`` output
    (configs -> method -> {mean_time, n_elements})."""
    plt = _plt()
    method_names = {"0": "ADMM", "1": "Euler", "2": "backward Euler"}
    fig, ax = plt.subplots(figsize=(6, 4))
    cfgs = scale_results["configs"]
    methods = sorted({m for per_cfg in cfgs.values() for m in per_cfg})
    for m in methods:
        pts = sorted(
            (per_cfg[m]["n_elements"], per_cfg[m]["mean_time"])
            for per_cfg in cfgs.values()
            if m in per_cfg and per_cfg[m].get("n_elements")
        )
        if pts:
            ax.plot(*zip(*pts), "o-", label=method_names.get(m, m))
    ax.set_xlabel("number of simplices")
    ax.set_ylabel("wall time (s)")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_scaling(scaling: dict, out_path: str, title: str | None = None):
    """Device-scaling curve (create_parallel_plot, experiments.py:285-433),
    from ``run_device_scaling``'s output."""
    plt = _plt()
    devs = sorted(int(k) for k in scaling["devices"])
    times = [scaling["devices"][str(d)]["mean_time"] for d in devs]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(devs, times, "o-", label="measured")
    ax.plot(
        devs, [times[0] * devs[0] / d for d in devs], "k--", lw=0.8,
        label="ideal",
    )
    ax.set_xlabel("devices")
    ax.set_ylabel("wall time (s)")
    ax.set_xscale("log", base=2)
    ax.set_yscale("log")
    ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_boundary_points(X, mask, out_path: str, title: str | None = None):
    """Scatter of boundary nodes (plot.py mode 3 — the reference reads a
    ``boundaryPnts.txt`` dump; here the nodes come straight from the mask).
    2D scatter or 3D axes by dimension."""
    from ..geometry.node_type import NodeType

    plt = _plt()
    X = _np(X)
    mask = _np(mask)
    b = X[mask != NodeType.INTERIOR]
    fig = plt.figure()
    if X.shape[1] == 3:
        ax = fig.add_subplot(projection="3d")
        ax.scatter(b[:, 0], b[:, 1], b[:, 2], s=2)
    else:
        ax = fig.add_subplot()
        ax.scatter(b[:, 0], b[:, 1], s=2)
        ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path
