"""The ``SquareGrid`` test type in 3D: a frozen copy of the 3D path of
``mmadmm_tpu_torch/geometry/rect_mesh.py``.

Re-implements ``utils::generateUniformRectMesh`` (reference
``src/MeshUtils.h:82-335``) as vectorized NumPy, preserving node ordering,
element ordering/orientation, and the boundary/corner masking semantics:
grid nodes followed by cell midpoints, 12 tets per cell
(``MeshUtils.h:208-292``).
"""

from __future__ import annotations

import numpy as np

from ..node_type import NodeType


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


def mesh(cfg: dict):
    """``(X [NP, 3] float64, F [NF, 4] int32, mask [NP] int8)`` of a 3D
    SquareGrid configuration (reference-schema keys)."""
    if int(cfg["Dim"]) != 3:
        raise ValueError("the benchmark's SquareGrid covers 3D configurations")
    btype = NodeType.BOUNDARY_FREE if int(cfg["BoundaryType"]) == 0 else NodeType.BOUNDARY_FIXED
    return _generate_3d(int(cfg["nx"]), int(cfg["ny"]), int(cfg["nz"]), float(cfg["xa"]),
                        float(cfg["xb"]), float(cfg["ya"]), float(cfg["yb"]), float(cfg["za"]),
                        float(cfg["zb"]), btype)
