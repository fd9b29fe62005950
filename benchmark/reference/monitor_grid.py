"""The monitor background grid of a 3D mesh and its frozen-cell samples,
written plainly from the grid's node values (the rules of the reference's
``src/MeshInterpolator.cpp``, as ``mmadmm_tpu_torch/ops/monitor_grid.py``
states them):

1. a uniform grid with ``n = int((NP*3)^(1/3))`` cells per axis over the
   vertex bounding box,
2. the monitor evaluated at the mesh vertices and copied to the grid
   nodes by nearest vertex (least index on ties, ``nn.py``),
3. two weighted-Jacobi sweeps of the interior grid nodes (0.6 centre,
   0.4/6 each of the 6 neighbours),
4. the reference's transpose quirk: the copy writes ``[k, i, j]`` and the
   sampler reads ``[k, j, i]``.

A point's cell is found by truncation, with the reference's unsigned
wrap-around: a point a whole cell or more below the grid takes the last
cell. The program keeps a 48-wide cell table or a constant; this module
reads the eight corners from the node values directly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .nn import grid_nn_map

SYM3 = [0, 1, 2, 4, 5, 8]  # (m00, m01, m02, m11, m12, m22) of a row-major 3x3


@dataclass
class Grid3:
    axes: tuple  # (x, y, z) node coordinates [n+1] each
    values: torch.Tensor  # [n+1, n+1, n+1, 9], indexed [k, j, i]


def _smooth(grid: np.ndarray, n_iters: int = 2) -> np.ndarray:
    g = grid.copy()
    h = 0.4 / 6.0
    for _ in range(n_iters):
        t = g.copy()
        g[1:-1, 1:-1, 1:-1] = 0.6 * t[1:-1, 1:-1, 1:-1] + h * (
            t[1:-1, 1:-1, 2:] + t[1:-1, 1:-1, :-2] + t[1:-1, 2:, 1:-1]
            + t[1:-1, :-2, 1:-1] + t[2:, 1:-1, 1:-1] + t[:-2, 1:-1, 1:-1]
        )
    return g


def build_grid(X: np.ndarray, monitor, *, dtype, device) -> Grid3:
    """The grid of the mesh vertices ``X [NP, 3]`` (float64) for the
    monitor ``monitor(x [N, 3]) -> [N, 3, 3]``."""
    NP, D = X.shape
    n = int((NP * D) ** (1.0 / D))
    mon = monitor(X).reshape(NP, D * D)
    lo, hi = X.min(axis=0), X.max(axis=0)
    i = np.arange(n + 1, dtype=np.float64)
    axes = tuple(lo[d] + i * (hi[d] - lo[d]) / n for d in range(D))
    nn = grid_nn_map(X, lo, hi, n)
    grid = mon[nn].reshape(n + 1, n + 1, n + 1, D * D)
    grid = _smooth(np.swapaxes(grid, 1, 2))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return Grid3(axes=tuple(t(a) for a in axes), values=t(grid))


def _cell_index(w, axis):
    last = axis.shape[0] - 2
    it = torch.trunc((w - axis[0]) / (axis[1] - axis[0])).to(torch.int64)
    return torch.where(it < 0, last, torch.clamp_max(it, last))


def cell_of(grid: Grid3, pts: torch.Tensor):
    """``(corners [..., 8, 9], bounds [..., 6])`` of the cells holding
    ``pts [..., 3]``: the corner tensors in the sampler's order (x fastest,
    then y, then z) and ``x0, x1, y0, y1, z0, z1``."""
    ax, ay, az = grid.axes
    xi, yi, zi = (_cell_index(pts[..., d], a) for d, a in enumerate(grid.axes))
    g = grid.values
    corners = torch.stack([g[zi + dz, yi + dy, xi + dx]
                           for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)], -2)
    bounds = torch.stack([ax[xi], ax[xi + 1], ay[yi], ay[yi + 1], az[zi], az[zi + 1]], -1)
    return corners, bounds


def gather_cell(grid: Grid3, pts: torch.Tensor) -> dict:
    """Frozen cells for ``huang.py``: ``vals [..., 8, 9]`` and the bounds
    by name."""
    corners, b = cell_of(grid, pts)
    keys = ("x0", "x1", "y0", "y1", "z0", "z1")
    return dict(vals=corners, **{k: b[..., i] for i, k in enumerate(keys)})


def cell_rows216(grid: Grid3, z_ch: torch.Tensor) -> torch.Tensor:
    """The plain K4's ``cells [216, N]`` for slot positions ``z_ch [12, N]``
    (channel ``v*3 + d``): per vertex its cell's 8 corners as 6 symmetric
    entries each, then the 6 bounds."""
    parts = []
    for v in range(4):
        corners, bounds = cell_of(grid, z_ch[3 * v:3 * v + 3].T)
        parts += [corners[..., SYM3].reshape(-1, 48).T, bounds.T]
    return torch.cat(parts).contiguous()


def sample_frozen(cell: dict, pnt: torch.Tensor) -> torch.Tensor:
    """Trilinear sample ``[..., 3, 3]`` from frozen cells
    (``evalMonitorOnGrid``)."""
    x0, x1, y0, y1 = cell["x0"], cell["x1"], cell["y0"], cell["y1"]
    z0, z1 = cell["z0"], cell["z1"]
    vals = cell["vals"]
    xd = (pnt[..., 0] - x0) / (x1 - x0)
    yd = (pnt[..., 1] - y0) / (y1 - y0)
    zd = (pnt[..., 2] - z0) / (z1 - z0)
    wts = [
        (1 - xd) * (1 - yd) * (1 - zd), xd * (1 - yd) * (1 - zd),
        (1 - xd) * yd * (1 - zd), xd * yd * (1 - zd),
        (1 - xd) * (1 - yd) * zd, xd * (1 - yd) * zd,
        (1 - xd) * yd * zd, xd * yd * zd,
    ]
    v = wts[0][..., None] * vals[..., 0, :]
    for c in range(1, 8):
        v = v + wts[c][..., None] * vals[..., c, :]
    return v.unflatten(-1, (3, 3))
