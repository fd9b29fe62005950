"""Monitor-function background grid: build (host, NumPy) and frozen-cell
sampling (device, PyTorch). Port of ``mmadmm_tpu/ops/monitor_grid.py``
(reference ``src/MeshInterpolator.cpp``):

1. a uniform background grid with ``n = int((NP*D)^(1/D))`` cells per axis
   over the vertex bounding box (the reference uses ``X->size()`` = NP*D),
2. the monitor evaluated at mesh vertices and copied to grid nodes by
   1-nearest-neighbor,
3. weighted-Jacobi smoothing of interior grid nodes, 5 sweeps in 2D
   (0.6 center + 0.1 x 4 neighbors), 2 in 3D (0.6 + 0.4/6 x 6),
4. the cell table, so one row fetch gives a vertex's whole interpolation
   cell. 2D: 16 wide, per cell ``(v00, v10, v01, v11)`` as
   ``(m00, m01, m11)`` each, then ``x0, x1, y0, y1``. 3D: 48 wide, the 8
   corners as ``(m00, m01, m02, m11, m12, m22)`` each; the bounds come
   from the axes.

Every shipped monitor is symmetric, and NN copy plus Jacobi smoothing keep
the off-diagonal pairs equal bitwise, which the symmetric tables above
rely on. A monitor that is not symmetric takes the 20-wide 2D table (the
four full corner tensors, then the bounds; ``monitor_grid.py:191-193`` in
the JAX package) or the narrow 3D path: no table, the grid ``values``
``[n+1, n+1, n+1, 9]`` and eight corner fetches a vertex
(``:199-205``), which also serves symmetric 3D grids whose 48-wide table
would reach 1 GiB. Only the symmetric tables feed a kernel
(``kernel_table``); the mesh sends the other grids to the generic prox.
A 3D grid whose nodes all hold the same tensor (a constant monitor, the
identity of the 3DMonitor1 family) is marked ``constant``: it keeps only
that tensor's 6 entries, and every cell's corners are that row (as the JAX
package's constant grid; its bounds table equals the axis values bit for
bit, so the port reads the axes).

Reference 3D quirk kept (``compat_3d_transpose`` in the JAX package): the
3D NN copy writes ``[k, i, j]`` while the sampler reads ``[k, j, i]``
(``MeshInterpolator.cpp:198`` vs ``:329-336``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..runtime.nn import grid_nn_map

ROW_W = 16  # cell-table row width (symmetric 2D layout)
ROW_W_FULL = 20  # the 2D row of a monitor that is not symmetric: 4 corners x 4, bounds
TABLE_W3 = 48  # symmetric 3D table row: 8 corners x 6 entries
TABLE3_MAX_BYTES = 2**30  # float32 bytes past which a 3D grid takes the narrow path
SYM3 = [0, 1, 2, 4, 5, 8]  # (m00, m01, m02, m11, m12, m22) of a row-major 3x3
FULL9 = [0, 1, 2, 1, 3, 4, 2, 4, 5]  # the row-major 3x3 from those 6


@dataclass
class MonitorGrid:
    axes: tuple  # (x, y[, z]) grid node coordinates
    cell_table: Optional[torch.Tensor]  # [ncells, 16, 20 or 48]; None if constant or narrow
    constant: bool = False  # 3D only: every node holds ``sym6``
    sym6: Optional[torch.Tensor] = None  # [6], the constant grid's entries
    values: Optional[torch.Tensor] = None  # the narrow 3D path's grid [n+1, n+1, n+1, 9]

    @property
    def dim(self) -> int:
        return len(self.axes)

    @property
    def kernel_table(self) -> bool:
        """Whether the prox and Euler kernels can read this grid: the
        16-wide 2D table, the 48-wide 3D one or a constant 3D grid."""
        if self.dim == 2:
            return self.cell_table.shape[-1] == ROW_W
        return self.constant or self.cell_table is not None


def _linspace_ref(lo: float, hi: float, ns: int) -> np.ndarray:
    """utils::linspace (MeshUtils.h:24-29): lo + i*(hi-lo)/ns, i=0..ns."""
    i = np.arange(ns + 1, dtype=np.float64)
    return lo + i * (hi - lo) / ns


def _smooth_grid(grid: np.ndarray, n_iters: int) -> np.ndarray:
    """Weighted-Jacobi smoothing of interior nodes
    (MeshInterpolator.cpp:366-404)."""
    g = grid.copy()
    if grid.ndim == 3:  # 2D: [ny+1, nx+1, DD]
        for _ in range(n_iters):
            t = g.copy()
            g[1:-1, 1:-1] = 0.6 * t[1:-1, 1:-1] + 0.1 * (
                t[1:-1, 2:] + t[1:-1, :-2] + t[2:, 1:-1] + t[:-2, 1:-1]
            )
        return g
    h = 0.4 / 6.0  # 3D: [nz+1, ny+1, nx+1, DD]
    for _ in range(n_iters):
        t = g.copy()
        g[1:-1, 1:-1, 1:-1] = 0.6 * t[1:-1, 1:-1, 1:-1] + h * (
            t[1:-1, 1:-1, 2:] + t[1:-1, 1:-1, :-2] + t[1:-1, 2:, 1:-1]
            + t[1:-1, :-2, 1:-1] + t[2:, 1:-1, 1:-1] + t[:-2, 1:-1, 1:-1]
        )
    return g


def _table_3d(grid: np.ndarray) -> np.ndarray:
    """The 48-wide symmetric 3D table ``[n^3, 48]``, cells ``(k, j, i)``
    i fastest, corners in the sampler's order."""
    g = grid
    corners = [
        g[:-1, :-1, :-1], g[:-1, :-1, 1:], g[:-1, 1:, :-1], g[:-1, 1:, 1:],
        g[1:, :-1, :-1], g[1:, :-1, 1:], g[1:, 1:, :-1], g[1:, 1:, 1:],
    ]
    table = np.concatenate([c[..., SYM3] for c in corners], axis=-1)
    return table.reshape(-1, TABLE_W3)


def build_monitor_grid_np(X: np.ndarray, monitor, num_smooth: Optional[int] = None):
    """Host build: returns ``(axes, cell_table, sym6, values)`` as float64
    NumPy arrays, the last three None where they do not apply. 2D:
    ``cell_table [n*n, 16]``, or ``[n*n, 20]`` for a monitor that is not
    symmetric. 3D: the 48-wide ``cell_table [n^3, 48]``; for a constant
    grid its 6 entries ``sym6``; else the narrow path's ``values``."""
    NP, D = X.shape
    n = int((NP * D) ** (1.0 / D))  # MeshInterpolator.cpp:78-85 uses X.size()
    if num_smooth is None:
        num_smooth = 5 if D == 2 else 2  # MeshInterpolator.cpp:247-252
    mon_vals = monitor(X).reshape(NP, D * D)
    lo = X.min(axis=0)
    hi = X.max(axis=0)
    axes = tuple(_linspace_ref(lo[d], hi[d], n) for d in range(D))
    nn = grid_nn_map(X, lo, hi, n)
    if D == 3:
        grid = mon_vals[nn].reshape(n + 1, n + 1, n + 1, D * D)  # [k, j, i, :]
        grid = _smooth_grid(np.swapaxes(grid, 1, 2), num_smooth)  # the 3D transpose quirk
        flat = grid.reshape(-1, D * D)
        if np.all(flat == flat[0]):
            return axes, None, flat[0][SYM3], None
        symmetric = (np.array_equal(grid[..., 1], grid[..., 3])
                     and np.array_equal(grid[..., 2], grid[..., 6])
                     and np.array_equal(grid[..., 5], grid[..., 7]))
        if symmetric and n ** 3 * TABLE_W3 * 4 < TABLE3_MAX_BYTES:
            return axes, _table_3d(grid), None, None
        return axes, None, None, grid
    grid = _smooth_grid(mon_vals[nn].reshape(n + 1, n + 1, D * D), num_smooth)
    ax, ay = axes
    ny, nx = n, n
    # the symmetric (m00, m01, m11) corners, or all four entries
    sym = [0, 1, 3] if np.array_equal(grid[..., 1], grid[..., 2]) else [0, 1, 2, 3]
    parts = [
        grid[:-1, :-1][..., sym], grid[:-1, 1:][..., sym],
        grid[1:, :-1][..., sym], grid[1:, 1:][..., sym],
        np.broadcast_to(ax[None, :-1], (ny, nx))[..., None],
        np.broadcast_to(ax[None, 1:], (ny, nx))[..., None],
        np.broadcast_to(ay[:-1, None], (ny, nx))[..., None],
        np.broadcast_to(ay[1:, None], (ny, nx))[..., None],
    ]
    table = np.concatenate(parts, axis=-1)
    return axes, table.reshape(ny * nx, table.shape[-1]), None, None


def build_monitor_grid(X: np.ndarray, monitor, *, dtype, device) -> MonitorGrid:
    """Build on the host and move the grid to ``device`` in ``dtype``."""
    axes, table, sym6, values = build_monitor_grid_np(X, monitor)

    def t(a):
        if a is None:
            return None
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return MonitorGrid(axes=tuple(t(a) for a in axes), cell_table=t(table),
                       constant=sym6 is not None, sym6=t(sym6), values=t(values))


def cell_index(w: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """utils::findLimInfMeshPoint (MeshUtils.h:45-54), including the
    uint32-wraparound clamp: a point below the grid by a whole cell or
    more takes the *last* cell. Returns int64 cell indices."""
    last = axis.shape[0] - 2
    t = (w - axis[0]) / (axis[1] - axis[0])
    it = torch.trunc(t).to(torch.int64)  # C (int) cast truncates toward 0
    return torch.where(it < 0, last, torch.clamp_max(it, last))


def cell_rows(grid: MonitorGrid, pts: torch.Tensor) -> torch.Tensor:
    """Cell-table rows ``[..., 16 or 20]`` for points ``pts [..., 2]``."""
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


def element_cell_rows(grid: MonitorGrid, z: torch.Tensor) -> torch.Tensor:
    """The prox kernels' cell channels for element-major vertex positions
    ``z [NF, D+1, D]``: ``cell_rows48``'s ``[48, NF]`` in 2D,
    ``cell_rows216``'s ``[216, NF]`` in 3D, vertex-major (the JAX
    element-major entries, ``prox_pallas2d.py:705-709`` and
    ``prox_pallas3d.py:441-462``)."""
    z_ch = z.reshape(z.shape[0], -1).T
    return (cell_rows48 if grid.dim == 2 else cell_rows216)(grid, z_ch)


def _cells_3d(grid: MonitorGrid, pts: torch.Tensor):
    """``(vals, bounds [..., 6])`` of the 3D cells holding ``pts [..., 3]``:
    the corner entries from the 48-wide table (``vals [..., 48]``), None
    for a constant grid, or on the narrow path the eight corner tensors
    ``[..., 8, 9]`` from the grid values; ``x0, x1, y0, y1, z0, z1`` from
    the axes."""
    ax, ay, az = grid.axes
    n = ax.shape[0] - 1
    xi = cell_index(pts[..., 0], ax)
    yi = cell_index(pts[..., 1], ay)
    zi = cell_index(pts[..., 2], az)
    bounds = torch.stack([ax[xi], ax[xi + 1], ay[yi], ay[yi + 1], az[zi], az[zi + 1]], -1)
    if grid.values is not None:
        g = grid.values
        vals = torch.stack([g[zi + dz, yi + dy, xi + dx]
                            for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)], -2)
        return vals, bounds
    vals = None if grid.constant else grid.cell_table[(zi * n + yi) * n + xi]
    return vals, bounds


def cell_rows216(grid: MonitorGrid, z_ch: torch.Tensor) -> torch.Tensor:
    """Kernel K4's ``cells [216, N]`` input, fetched at the slot positions
    ``z_ch [12, N]`` (channel ``v*3 + d``): per vertex, vertex-major, its
    cell's 48 corner entries (the broadcast ``sym6`` row on a constant
    grid) and the 6 bounds (``admm_soa.py:642-665`` in the JAX package)."""
    parts = []
    for v in range(4):
        vals, bounds = _cells_3d(grid, z_ch[3 * v:3 * v + 3].T)
        if vals is None:
            vals = grid.sym6.repeat(8)[None].expand(z_ch.shape[1], TABLE_W3)
        parts += [vals.T, bounds.T]
    return torch.cat(parts).contiguous()


def gather_cell(grid: MonitorGrid, pts: torch.Tensor) -> dict:
    """Frozen interpolation cells for points ``pts [..., D]``: corner
    tensors ``vals [..., 2^D, D*D]`` (row-major, the symmetric entries
    repeated) and the cell bounds ``x0, x1, y0, y1[, z0, z1] [...]``."""
    if grid.dim == 3:
        vals, b = _cells_3d(grid, pts)
        if vals is None:
            full = grid.sym6[FULL9].expand(*pts.shape[:-1], 8, 9)
        elif grid.values is not None:
            full = vals
        else:
            full = vals.unflatten(-1, (8, 6))[..., FULL9]
        keys = ("x0", "x1", "y0", "y1", "z0", "z1")
        return dict(vals=full, **{k: b[..., i] for i, k in enumerate(keys)})
    row = cell_rows(grid, pts)
    if row.shape[-1] == ROW_W_FULL:
        vals = row[..., :16].unflatten(-1, (4, 4))
    else:
        v = row[..., :12].unflatten(-1, (4, 3))
        vals = torch.stack([v[..., 0], v[..., 1], v[..., 1], v[..., 2]], dim=-1)
    return dict(vals=vals, x0=row[..., -4], x1=row[..., -3],
                y0=row[..., -2], y1=row[..., -1])


def sample_monitor(grid: MonitorGrid, pts: torch.Tensor) -> torch.Tensor:
    """The bi- or trilinear monitor sample ``[..., D, D]`` at ``pts [...,
    D]`` (``evalMonitorOnGrid``, ``MeshInterpolator.cpp:287-342``): the
    cell's corners fetched, then ``sample_frozen``, the same expression."""
    return sample_frozen(gather_cell(grid, pts), pts)


def sample_frozen(cell: dict, pnt: torch.Tensor) -> torch.Tensor:
    """Bi- or trilinear sample ``[..., D, D]`` from frozen cells (no
    gathers)."""
    x0, x1, y0, y1 = cell["x0"], cell["x1"], cell["y0"], cell["y1"]
    vals = cell["vals"]
    if pnt.shape[-1] == 3:
        z0, z1 = cell["z0"], cell["z1"]
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
    norm = 1.0 / ((x1 - x0) * (y1 - y0))
    x, y = pnt[..., 0], pnt[..., 1]
    c00 = norm * (x1 - x) * (y1 - y)
    c10 = norm * (x - x0) * (y1 - y)
    c01 = norm * (x1 - x) * (y - y0)
    c11 = norm * (x - x0) * (y - y0)
    v = (c00[..., None] * vals[..., 0, :] + c10[..., None] * vals[..., 1, :]
         + c01[..., None] * vals[..., 2, :] + c11[..., None] * vals[..., 3, :])
    return v.unflatten(-1, (2, 2))
