"""Monitor-function background grid: build (host, NumPy) and frozen-cell
sampling (device, PyTorch). Port of ``mmadmm_tpu/ops/monitor_grid.py``
for 2D meshes (reference ``src/MeshInterpolator.cpp``):

1. a uniform background grid with ``n = int((NP*D)^(1/D))`` cells per axis
   over the vertex bounding box (the reference uses ``X->size()`` = NP*D),
2. the monitor evaluated at mesh vertices and copied to grid nodes by
   1-nearest-neighbor,
3. weighted-Jacobi smoothing of interior grid nodes, 5 sweeps in 2D
   (0.6 center + 0.1 x 4 neighbors),
4. the symmetric 16-wide cell table: per cell
   ``(v00, v10, v01, v11)`` as ``(m00, m01, m11)`` each, then
   ``x0, x1, y0, y1``, so one row fetch gives a vertex's whole
   interpolation cell.

Every shipped monitor is symmetric, and NN copy plus Jacobi smoothing keep
``m01 == m10`` bitwise, so the 16-wide table is the only layout the port
builds. 3D grids are ROADMAP item A13.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..runtime.nn import grid_nn_map

ROW_W = 16  # cell-table row width (symmetric 2D layout)


@dataclass
class MonitorGrid:
    axes: tuple  # (x, y) grid node coordinates
    cell_table: torch.Tensor  # [ny*nx, 16]


def _linspace_ref(lo: float, hi: float, ns: int) -> np.ndarray:
    """utils::linspace (MeshUtils.h:24-29): lo + i*(hi-lo)/ns, i=0..ns."""
    i = np.arange(ns + 1, dtype=np.float64)
    return lo + i * (hi - lo) / ns


def _smooth_grid(grid: np.ndarray, n_iters: int) -> np.ndarray:
    """Weighted-Jacobi smoothing of interior nodes
    (MeshInterpolator.cpp:366-404), 2D."""
    g = grid.copy()
    for _ in range(n_iters):
        t = g.copy()
        g[1:-1, 1:-1] = 0.6 * t[1:-1, 1:-1] + 0.1 * (
            t[1:-1, 2:] + t[1:-1, :-2] + t[2:, 1:-1] + t[:-2, 1:-1]
        )
    return g


def build_monitor_grid_np(X: np.ndarray, monitor, num_smooth: int = 5):
    """Host build: returns ``(axes (x, y), cell_table [n*n, 16])`` as
    float64 NumPy arrays."""
    NP, D = X.shape
    if D != 2:
        raise NotImplementedError("3D monitor grids are ROADMAP item A13")
    n = int((NP * D) ** (1.0 / D))  # MeshInterpolator.cpp:78-85 uses X.size()
    mon_vals = monitor(X).reshape(NP, D * D)
    lo = X.min(axis=0)
    hi = X.max(axis=0)
    axes = tuple(_linspace_ref(lo[d], hi[d], n) for d in range(D))
    nn = grid_nn_map(X, lo, hi, n)
    grid = _smooth_grid(mon_vals[nn].reshape(n + 1, n + 1, D * D), num_smooth)
    if not np.array_equal(grid[..., 1], grid[..., 2]):
        raise NotImplementedError(
            "non-symmetric monitors need the 20-wide cell table (not ported)"
        )
    ax, ay = axes
    ny, nx = n, n
    sym = [0, 1, 3]
    parts = [
        grid[:-1, :-1][..., sym], grid[:-1, 1:][..., sym],
        grid[1:, :-1][..., sym], grid[1:, 1:][..., sym],
        np.broadcast_to(ax[None, :-1], (ny, nx))[..., None],
        np.broadcast_to(ax[None, 1:], (ny, nx))[..., None],
        np.broadcast_to(ay[:-1, None], (ny, nx))[..., None],
        np.broadcast_to(ay[1:, None], (ny, nx))[..., None],
    ]
    return axes, np.concatenate(parts, axis=-1).reshape(ny * nx, ROW_W)


def build_monitor_grid(X: np.ndarray, monitor, *, dtype, device) -> MonitorGrid:
    """Build on the host and move the grid to ``device`` in ``dtype``."""
    axes, table = build_monitor_grid_np(X, monitor)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return MonitorGrid(axes=tuple(t(a) for a in axes), cell_table=t(table))


def cell_index(w: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """utils::findLimInfMeshPoint (MeshUtils.h:45-54), including the
    uint32-wraparound clamp: a point below the grid by a whole cell or
    more takes the *last* cell. Returns int64 cell indices."""
    last = axis.shape[0] - 2
    t = (w - axis[0]) / (axis[1] - axis[0])
    it = torch.trunc(t).to(torch.int64)  # C (int) cast truncates toward 0
    return torch.where(it < 0, last, torch.clamp_max(it, last))


def cell_rows(grid: MonitorGrid, pts: torch.Tensor) -> torch.Tensor:
    """Cell-table rows ``[..., 16]`` for points ``pts [..., 2]``."""
    ax, ay = grid.axes
    ncx = ax.shape[0] - 1
    xi = cell_index(pts[..., 0], ax)
    yi = cell_index(pts[..., 1], ay)
    return grid.cell_table[yi * ncx + xi]


def cell_rows48(grid: MonitorGrid, z_ch: torch.Tensor) -> torch.Tensor:
    """The three per-vertex cell-table rows of every element slot, the
    kernels' ``cells [48, N]`` input (vertex-major), fetched at the slot
    positions ``z_ch [6, N]`` (channel ``v*2 + d``)."""
    rows = [cell_rows(grid, z_ch[2 * v:2 * v + 2].T).T for v in range(3)]
    return torch.cat(rows).contiguous()


def gather_cell(grid: MonitorGrid, pts: torch.Tensor) -> dict:
    """Frozen interpolation cells for points ``pts [..., 2]``: corner
    tensors ``vals [..., 4, 4]`` (row-major ``m00, m01, m10, m11`` with
    ``m10 := m01``) and the cell bounds ``x0, x1, y0, y1 [...]``."""
    row = cell_rows(grid, pts)
    v = row[..., :12].unflatten(-1, (4, 3))
    vals = torch.stack([v[..., 0], v[..., 1], v[..., 1], v[..., 2]], dim=-1)
    return dict(vals=vals, x0=row[..., 12], x1=row[..., 13],
                y0=row[..., 14], y1=row[..., 15])


def sample_frozen(cell: dict, pnt: torch.Tensor) -> torch.Tensor:
    """Bilinear sample ``[..., 2, 2]`` from frozen cells (no gathers)."""
    x0, x1, y0, y1 = cell["x0"], cell["x1"], cell["y0"], cell["y1"]
    vals = cell["vals"]
    norm = 1.0 / ((x1 - x0) * (y1 - y0))
    x, y = pnt[..., 0], pnt[..., 1]
    c00 = norm * (x1 - x) * (y1 - y)
    c10 = norm * (x - x0) * (y1 - y)
    c01 = norm * (x1 - x) * (y - y0)
    c11 = norm * (x - x0) * (y - y0)
    v = (c00[..., None] * vals[..., 0, :] + c10[..., None] * vals[..., 1, :]
         + c01[..., None] * vals[..., 2, :] + c11[..., None] * vals[..., 3, :])
    return v.unflatten(-1, (2, 2))
