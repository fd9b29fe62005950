"""3D structured-grid stencil operators (port of
``mmadmm_tpu/ops/stencil3d.py``).

The uniform box mesh splits each cell into 12 tetrahedra around its
centroid (``MeshUtils.h:205-295``); a Shoulder carve drops elements but
never compacts nodes. So element-node incidence is a stencil:

* ``D x`` is window slices of the grid page and the centroid page,
* ``D^T y`` is 8 shifted pad-adds into the grid page plus one centroid
  add.

Element slots are channel-major ``[12, NFd]`` (channel ``v*3 + d``, dense
element order ``e = 12*cell + t``, cells ``(k, j, i)`` i fastest); node
fields are ``[3, NP]`` (grid nodes first, then centroids). Per tet t,
vertices 0..2 are cell corners and vertex 3 the centroid. Reorientation
swaps (v1 <-> v2 on negative-volume tets, data-dependent after the
Shoulder perturbation) and the carve come in as ``[12, ncell]`` masks
built from the mesh's actual F. The three coordinates go through each
operation together; each one's arithmetic is the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fnn

# per tet t, the corner offsets (di, dj, dk) of vertices 0..2
# (MeshUtils.h:213-291; vertex 3 is always the centroid)
TETS_3D = [
    ((0, 0, 0), (1, 0, 0), (1, 1, 0)),
    ((0, 0, 0), (0, 1, 0), (1, 1, 0)),
    ((0, 0, 1), (1, 0, 1), (1, 1, 1)),
    ((0, 0, 1), (0, 1, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 1, 0), (0, 1, 1)),
    ((0, 0, 0), (0, 0, 1), (0, 1, 1)),
    ((1, 0, 0), (1, 1, 0), (1, 1, 1)),
    ((1, 0, 0), (1, 0, 1), (1, 1, 1)),
    ((0, 0, 0), (1, 0, 0), (0, 0, 1)),
    ((1, 0, 0), (1, 0, 1), (0, 0, 1)),
    ((0, 1, 0), (1, 1, 0), (0, 1, 1)),
    ((1, 1, 0), (1, 1, 1), (0, 1, 1)),
]
OFFSETS = sorted({o for tet in TETS_3D for o in tet})


def canonical_dense_3d(nx: int, ny: int, nz: int) -> np.ndarray:
    """The uncarved, unreoriented ``F [12*ncell, 4]`` of the box mesh in
    dense element order."""
    sxy = (nx + 1) * (ny + 1)
    stride = sxy * (nz + 1)
    k3, j3, i3 = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    i3, j3, k3 = i3.ravel(), j3.ravel(), k3.ravel()

    def g(di, dj, dk):
        return (i3 + di) + (j3 + dj) * (nx + 1) + (k3 + dk) * sxy

    mid = stride + i3 + j3 * nx + k3 * (nx * ny)
    F = np.empty((12 * nx * ny * nz, 4), dtype=np.int64)
    for t, (a, b, c) in enumerate(TETS_3D):
        F[t::12] = np.stack([g(*a), g(*b), g(*c), mid], axis=1)
    return F


def match_dense_3d(nx: int, ny: int, nz: int, F_mesh):
    """Match a mesh's compact F (order-preserving carve plus possible
    v1<->v2 reorientation swaps) to the dense element order.

    Returns ``(alive [NFd] bool, swapped [NFd] bool, mesh_of_dense [NFd]
    int64)``, the JAX package's element-by-element merge computed with
    vectorized NumPy: every tet holds its cell's centroid, the largest
    node index, so the cell comes from that vertex and the tet from the
    set of its three corners. Raises ``ValueError`` if the elements are
    not an ordered subset of the dense ones."""
    Fc = canonical_dense_3d(nx, ny, nz)
    Fm = np.asarray(F_mesh, dtype=np.int64)
    ncell = nx * ny * nz
    NPg = (nx + 1) * (ny + 1) * (nz + 1)
    n = NPg + ncell

    def keys(F):  # (corner-set key, cell)
        s = np.sort(F, axis=1)
        if s.size and (s[:, 0].min() < 0 or s[:, 2].max() >= NPg or s[:, 3].min() < NPg
                       or s[:, 3].max() >= n):
            raise ValueError("elements are not corner-corner-corner-centroid tets")
        return (s[:, 0] * n + s[:, 1]) * n + s[:, 2], s[:, 3] - NPg

    kc, _ = keys(Fc)
    km, cell = keys(Fm)
    hit = kc.reshape(ncell, 12)[cell] == km[:, None]  # [NF, 12]
    if not np.all(hit.sum(1) == 1):
        raise ValueError("mesh elements are not elements of the dense grid")
    dense = 12 * cell + hit.argmax(1)
    if np.any(np.diff(dense) <= 0):
        raise ValueError("mesh elements are not an ordered subset of the dense grid")
    same = np.all(Fc[dense] == Fm, axis=1)
    flip = np.all(Fc[dense][:, [0, 2, 1, 3]] == Fm, axis=1)
    if not np.all(same | flip):
        raise ValueError("unexpected vertex permutation in the mesh elements")
    alive = np.zeros(12 * ncell, dtype=bool)
    swapped = np.zeros(12 * ncell, dtype=bool)
    mesh_of_dense = np.full(12 * ncell, -1, dtype=np.int64)
    alive[dense] = True
    swapped[dense] = ~same
    mesh_of_dense[dense] = np.arange(Fm.shape[0])
    return alive, swapped, mesh_of_dense


def dense_layout_3d(nx: int, ny: int, nz: int, mesh):
    """The stencil engine's gate: ``match_dense_3d``'s result for a mesh
    on the (nx, ny, nz) box grid, or ``None`` if its nodes are not the
    uncompacted grid-plus-centroid layout or its elements are not an
    ordered subset of the dense grid's."""
    if mesh.n_pnts != (nx + 1) * (ny + 1) * (nz + 1) + nx * ny * nz:
        return None
    try:
        return match_dense_3d(nx, ny, nz, mesh._F_np)
    except ValueError:
        return None


def make_stencil_ops_3d(nx: int, ny: int, nz: int):
    """Returns ``(gather_ch, scatter_ch)`` for the (nx, ny, nz) cell grid.

    ``gather_ch(x [3, NP], swap_t [12, ncell]) -> [12, NFd]``.
    ``scatter_ch(y [12, NFd], swap_t, alive_t [12, ncell]) -> [3, NP]``,
    masked ``D^T``: per corner offset the 12 tets are added in order, then
    the 8 padded pages in sorted-offset order; the centroids separately
    (the JAX package's order of adds).
    """
    NPg = (nx + 1) * (ny + 1) * (nz + 1)
    ncell = nx * ny * nz
    NFd = 12 * ncell

    def gather_ch(x, swap_t):
        page = x[:, :NPg].reshape(3, nz + 1, ny + 1, nx + 1)
        M = x[:, NPg:]
        corners = {
            (di, dj, dk): page[:, dk:dk + nz, dj:dj + ny, di:di + nx].reshape(3, ncell)
            for di, dj, dk in OFFSETS
        }
        chans = []
        for v in range(4):
            per_t = []
            for t in range(12):
                if v == 3:
                    a = M
                else:
                    a = corners[TETS_3D[t][v]]
                    if v in (1, 2):
                        b = corners[TETS_3D[t][3 - v]]
                        sk = swap_t[t]
                        a = sk * b + (1.0 - sk) * a
                per_t.append(a)
            chans.append(torch.stack(per_t, dim=-1).reshape(3, NFd))
        return torch.cat(chans)

    def scatter_ch(y, swap_t, alive_t):
        per_v = [y[3 * v:3 * v + 3].reshape(3, ncell, 12) for v in range(4)]
        acc = {off: y.new_zeros((3, ncell)) for off in OFFSETS}
        acc_m = y.new_zeros((3, ncell))
        for t in range(12):
            av = alive_t[t]
            sk = swap_t[t]
            pv = [per_v[v][:, :, t] * av for v in range(4)]
            p1 = sk * pv[2] + (1.0 - sk) * pv[1]
            p2 = sk * pv[1] + (1.0 - sk) * pv[2]
            canon = (pv[0], p1, p2)
            for v in range(3):
                off = TETS_3D[t][v]
                acc[off] = acc[off] + canon[v]
            acc_m = acc_m + pv[3]
        page = None
        for di, dj, dk in OFFSETS:
            # F.pad takes (x_lo, x_hi, y_lo, y_hi, z_lo, z_hi)
            p = Fnn.pad(acc[(di, dj, dk)].reshape(3, nz, ny, nx),
                        (di, 1 - di, dj, 1 - dj, dk, 1 - dk))
            page = p if page is None else page + p
        return torch.cat([page.reshape(3, NPg), acc_m], dim=1)

    return gather_ch, scatter_ch
