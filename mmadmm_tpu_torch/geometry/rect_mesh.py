"""Uniform rectangle / box mesh with cell midpoints.

Re-implements ``utils::generateUniformRectMesh`` (reference
``src/MeshUtils.h:82-335``) as vectorized NumPy, preserving node ordering,
element ordering/orientation, and the boundary/corner masking semantics so
that generated meshes are bit-identical to the reference for the shipped
(square) configurations.

2D: (nx+1)*(ny+1) grid nodes followed by nx*ny cell midpoints; each cell is
split into 4 triangles (Left, Top, Right, Bottom fans around the midpoint,
``MeshUtils.h:126-155``). 3D: grid + midpoints, 12 tets per cell
(``MeshUtils.h:208-292``).

Deviations from the reference (documented, intentional):
  * the reference computes the 2D boundary row index as ``i / (ny+1)``
    (``MeshUtils.h:163``) which is only correct for nx == ny (every shipped
    config); we use the correct ``i // (nx+1)``.
"""

from __future__ import annotations

import numpy as np

from .node_type import NodeType


def _grid_coords_2d(nx, ny, xa, xb, ya, yb):
    hx = (xb - xa) / float(nx)
    hy = (yb - ya) / float(ny)
    i = np.arange(nx + 1, dtype=np.float64)
    j = np.arange(ny + 1, dtype=np.float64)
    # node (i, j) at index i + j*(nx+1)  (MeshUtils.h:105-111)
    gx = xa + hx * i
    gy = ya + hy * j
    X = np.empty(((nx + 1) * (ny + 1), 2), dtype=np.float64)
    X[:, 0] = np.tile(gx, ny + 1)
    X[:, 1] = np.repeat(gy, nx + 1)
    # midpoints, index stride + i + j*nx  (MeshUtils.h:114-121)
    mi = np.arange(nx, dtype=np.float64)
    mj = np.arange(ny, dtype=np.float64)
    mx = xa + hx * mi + hx / 2.0
    my = ya + hy * mj + hy / 2.0
    M = np.empty((nx * ny, 2), dtype=np.float64)
    M[:, 0] = np.tile(mx, ny)
    M[:, 1] = np.repeat(my, nx)
    return np.concatenate([X, M], axis=0), hx, hy


def generate_uniform_rect_mesh(
    dim: int,
    nx: int,
    ny: int,
    nz: int = 0,
    xa: float = 0.0,
    xb: float = 1.0,
    ya: float = 0.0,
    yb: float = 1.0,
    za: float = 0.0,
    zb: float = 1.0,
    boundary_type: NodeType = NodeType.BOUNDARY_FIXED,
):
    """Return ``(X[NP, D] f64, F[NF, D+1] i32, mask[NP] i8)``."""
    if dim == 2:
        return _generate_2d(nx, ny, xa, xb, ya, yb, boundary_type)
    elif dim == 3:
        return _generate_3d(nx, ny, nz, xa, xb, ya, yb, za, zb, boundary_type)
    raise ValueError(f"dim must be 2 or 3, got {dim}")


def _generate_2d(nx, ny, xa, xb, ya, yb, btype):
    X, hx, hy = _grid_coords_2d(nx, ny, xa, xb, ya, yb)
    stride = (nx + 1) * (ny + 1)

    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    ii = ii.ravel()  # i fast, j slow: cell (i, j) order matches MeshUtils.h:126-127
    jj = jj.ravel()
    bl = ii + jj * (nx + 1)  # bottom-left grid node
    br = ii + 1 + jj * (nx + 1)
    tl = ii + (jj + 1) * (nx + 1)
    tr = ii + 1 + (jj + 1) * (nx + 1)
    mid = stride + ii + jj * nx

    ncell = nx * ny
    F = np.empty((4 * ncell, 3), dtype=np.int32)
    # Left / Top / Right / Bottom triangles (MeshUtils.h:128-153)
    F[0::4] = np.stack([bl, mid, tl], axis=1)
    F[1::4] = np.stack([mid, tr, tl], axis=1)
    F[2::4] = np.stack([mid, tr, br], axis=1)
    F[3::4] = np.stack([bl, br, mid], axis=1)

    mask = np.full(X.shape[0], NodeType.INTERIOR, dtype=np.int8)
    gi = np.arange(stride)
    i_off = gi % (nx + 1)
    j_off = gi // (nx + 1)  # reference uses i/(ny+1): identical when nx == ny
    boundary = (i_off == 0) | (i_off == nx) | (j_off == 0) | (j_off == ny)
    mask[gi[boundary]] = btype
    corner = ((i_off == 0) | (i_off == nx)) & ((j_off == 0) | (j_off == ny))
    mask[gi[corner]] = NodeType.BOUNDARY_FIXED
    return X, F, mask


def _generate_3d(nx, ny, nz, xa, xb, ya, yb, za, zb, btype):
    hx = (xb - xa) / float(nx)
    hy = (yb - ya) / float(ny)
    hz = (zb - za) / float(nz)

    # grid node (i, j, k) at i + j*(nx+1) + k*(nx+1)*(ny+1)  (MeshUtils.h:180-190)
    gx = xa + hx * np.arange(nx + 1, dtype=np.float64)
    gy = ya + hy * np.arange(ny + 1, dtype=np.float64)
    gz = za + hz * np.arange(nz + 1, dtype=np.float64)
    n_grid = (nx + 1) * (ny + 1) * (nz + 1)
    G = np.empty((n_grid, 3), dtype=np.float64)
    G[:, 0] = np.tile(gx, (ny + 1) * (nz + 1))
    G[:, 1] = np.tile(np.repeat(gy, nx + 1), nz + 1)
    G[:, 2] = np.repeat(gz, (nx + 1) * (ny + 1))

    # midpoint (i, j, k) at stride + i + j*nx + k*nx*ny  (MeshUtils.h:193-203)
    mx = xa + hx * np.arange(nx, dtype=np.float64) + hx / 2.0
    my = ya + hy * np.arange(ny, dtype=np.float64) + hy / 2.0
    mz = za + hz * np.arange(nz, dtype=np.float64) + hz / 2.0
    M = np.empty((nx * ny * nz, 3), dtype=np.float64)
    M[:, 0] = np.tile(mx, ny * nz)
    M[:, 1] = np.tile(np.repeat(my, nx), nz)
    M[:, 2] = np.repeat(mz, nx * ny)
    X = np.concatenate([G, M], axis=0)

    stride = n_grid
    sxy = (nx + 1) * (ny + 1)

    k3, j3, i3 = np.meshgrid(
        np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"
    )
    i3, j3, k3 = i3.ravel(), j3.ravel(), k3.ravel()

    def g(i, j, k):
        return i + j * (nx + 1) + k * sxy

    mid = stride + i3 + j3 * nx + k3 * (nx * ny)

    # 12 tets per cell in the exact reference order (MeshUtils.h:213-291):
    # bottom x2, top x2, left x2, right x2, back x2, front x2.
    tets = [
        (g(i3, j3, k3), g(i3 + 1, j3, k3), g(i3 + 1, j3 + 1, k3), mid),
        (g(i3, j3, k3), g(i3, j3 + 1, k3), g(i3 + 1, j3 + 1, k3), mid),
        (g(i3, j3, k3 + 1), g(i3 + 1, j3, k3 + 1), g(i3 + 1, j3 + 1, k3 + 1), mid),
        (g(i3, j3, k3 + 1), g(i3, j3 + 1, k3 + 1), g(i3 + 1, j3 + 1, k3 + 1), mid),
        (g(i3, j3, k3), g(i3, j3 + 1, k3), g(i3, j3 + 1, k3 + 1), mid),
        (g(i3, j3, k3), g(i3, j3, k3 + 1), g(i3, j3 + 1, k3 + 1), mid),
        (g(i3 + 1, j3, k3), g(i3 + 1, j3 + 1, k3), g(i3 + 1, j3 + 1, k3 + 1), mid),
        (g(i3 + 1, j3, k3), g(i3 + 1, j3, k3 + 1), g(i3 + 1, j3 + 1, k3 + 1), mid),
        (g(i3, j3, k3), g(i3 + 1, j3, k3), g(i3, j3, k3 + 1), mid),
        (g(i3 + 1, j3, k3), g(i3 + 1, j3, k3 + 1), g(i3, j3, k3 + 1), mid),
        (g(i3, j3 + 1, k3), g(i3 + 1, j3 + 1, k3), g(i3, j3 + 1, k3 + 1), mid),
        (g(i3 + 1, j3 + 1, k3), g(i3 + 1, j3 + 1, k3 + 1), g(i3, j3 + 1, k3 + 1), mid),
    ]
    ncell = nx * ny * nz
    F = np.empty((12 * ncell, 4), dtype=np.int32)
    for t, (a, b, c, d) in enumerate(tets):
        F[t::12] = np.stack([a, b, c, d], axis=1)

    mask = np.full(X.shape[0], NodeType.INTERIOR, dtype=np.int8)
    # Boundary marking (MeshUtils.h:300-332). The reference computes, for the
    # flat in-plane index i in [0, (nx+1)*(ny+1)): iOff = i/(nx+1) (the y row)
    # and jOff = i%(ny+1) (the x column, valid for nx == ny).
    gi = np.arange(sxy)
    i_off = gi // (nx + 1)
    j_off = gi % (ny + 1)
    for k in range(nz + 1):
        boundary = (
            (i_off == 0) | (i_off == nx) | (j_off == 0) | (j_off == ny)
            | (k == 0) | (k == nz)
        )
        off = k * sxy + gi
        mask[off[boundary]] = btype
        corner = (
            (((i_off == 0) | (i_off == nx)) & ((j_off == 0) | (j_off == ny)))
            | (((i_off == 0) | (i_off == nx)) & ((k == 0) | (k == nz)))
            | (((j_off == 0) | (j_off == ny)) & ((k == 0) | (k == nz)))
        )
        mask[off[corner]] = NodeType.BOUNDARY_FIXED
    return X, F, mask
