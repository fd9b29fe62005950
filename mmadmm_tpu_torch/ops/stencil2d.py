"""2D structured-grid stencil operators (port of
``mmadmm_tpu/ops/stencil2d.py``).

On a uniform rect mesh with cell midpoints (``MeshUtils.h:104-155``) and a
Shoulder carve that drops elements without compacting nodes, element-node
incidence is a stencil:

* ``D x`` is a set of window slices of the grid and midpoint pages,
* ``D^T y`` is four shifted pad-adds into the grid page plus one
  midpoint add.

Element slots are channel-major ``[6, NFd]`` (channel ``v*2 + d``, dense
element order ``e = cell*4 + k``). The reorientation swaps (v1 <-> v2 on
negative-det triangles) and the carve come in as ``[4, ny, nx]`` masks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fnn

# canonical cell split (MeshUtils.h:128-153)
VMAP_2D = {
    0: ("bl", "M", "tl"),   # Left
    1: ("M", "tr", "tl"),   # Top
    2: ("M", "tr", "br"),   # Right
    3: ("bl", "br", "M"),   # Bottom
}


def make_stencil_ops(nx: int, ny: int):
    """Returns ``(gather_ch, scatter_ch)`` for the (nx, ny) cell grid.

    ``gather_ch(x [NP, 2], swap_k [4, ny, nx]) -> [6, NFd]``.
    ``scatter_ch(y [6, NFd], swap_k, alive_k) -> [NP, 2]``, masked ``D^T``.
    """
    stride = (nx + 1) * (ny + 1)
    NFd = 4 * nx * ny

    def gather_ch(x, swap_k):
        chans = [None] * 6
        for d in range(2):
            page = x[:stride, d].reshape(ny + 1, nx + 1)
            src = dict(
                bl=page[:-1, :-1], br=page[:-1, 1:],
                tl=page[1:, :-1], tr=page[1:, 1:],
                M=x[stride:, d].reshape(ny, nx),
            )
            for v in range(3):
                per_k = []
                for k in range(4):
                    a = src[VMAP_2D[k][v]]
                    if v in (1, 2):
                        b = src[VMAP_2D[k][3 - v]]
                        sk = swap_k[k]
                        a = sk * b + (1.0 - sk) * a
                    per_k.append(a)
                chans[v * 2 + d] = torch.stack(per_k, dim=-1).reshape(NFd)
        return torch.stack(chans)

    def scatter_ch(y, swap_k, alive_k):
        cols = []
        for d in range(2):
            acc = {kk: y.new_zeros((ny, nx)) for kk in ("bl", "br", "tl", "tr", "M")}
            per_v = [y[v * 2 + d].reshape(ny, nx, 4) for v in range(3)]
            for k in range(4):
                av = alive_k[k]
                sk = swap_k[k]
                pv = [per_v[v][:, :, k] * av for v in range(3)]
                p1 = sk * pv[2] + (1.0 - sk) * pv[1]
                p2 = sk * pv[1] + (1.0 - sk) * pv[2]
                canon = (pv[0], p1, p2)
                for v in range(3):
                    tgt = VMAP_2D[k][v]
                    acc[tgt] = acc[tgt] + canon[v]
            # F.pad takes (left, right, top, bottom) = (i_lo, i_hi, j_lo, j_hi)
            page = (
                Fnn.pad(acc["bl"], (0, 1, 0, 1)) + Fnn.pad(acc["br"], (1, 0, 0, 1))
                + Fnn.pad(acc["tl"], (0, 1, 1, 0)) + Fnn.pad(acc["tr"], (1, 0, 1, 0))
            )
            cols.append(torch.cat([page.reshape(stride), acc["M"].reshape(nx * ny)]))
        return torch.stack(cols, dim=1)

    return gather_ch, scatter_ch


def canonical_elements(nx: int, ny: int) -> np.ndarray:
    """The uncarved, unreoriented ``F [4*nx*ny, 3]`` of the rect mesh in
    dense element order (``MeshUtils.h:126-155``)."""
    stride = (nx + 1) * (ny + 1)
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    ii = ii.ravel()
    jj = jj.ravel()
    bl = ii + jj * (nx + 1)
    br = ii + 1 + jj * (nx + 1)
    tl = ii + (jj + 1) * (nx + 1)
    tr = ii + 1 + (jj + 1) * (nx + 1)
    mid = stride + ii + jj * nx
    Fc = np.empty((4 * nx * ny, 3), dtype=np.int64)
    Fc[0::4] = np.stack([bl, mid, tl], axis=1)
    Fc[1::4] = np.stack([mid, tr, tl], axis=1)
    Fc[2::4] = np.stack([mid, tr, br], axis=1)
    Fc[3::4] = np.stack([bl, br, mid], axis=1)
    return Fc


def match_dense(nx: int, ny: int, F_mesh):
    """Match a mesh's compact F (order-preserving carve plus possible
    v1<->v2 reorientation swaps) to the canonical dense element order.

    Returns ``(alive [NFd] bool, swapped [NFd] bool,
    mesh_of_dense [NFd] int64)``. Same result as the JAX package's
    element-by-element merge, computed with vectorized NumPy: the compact
    elements are the dense ones whose vertex sets occur in ``F_mesh``, in
    the same order.
    """
    Fc = canonical_elements(nx, ny)
    Fm = np.asarray(F_mesh, dtype=np.int64)
    n = int(max(Fc.max(), Fm.max(initial=0))) + 1

    def key(F):
        s = np.sort(F, axis=1)
        return (s[:, 0] * n + s[:, 1]) * n + s[:, 2]

    kc, km = key(Fc), key(Fm)
    alive = np.isin(kc, km)
    if not np.array_equal(kc[alive], km):
        raise ValueError("mesh elements are not an ordered subset of the dense grid")
    mesh_of_dense = np.full(Fc.shape[0], -1, dtype=np.int64)
    mesh_of_dense[alive] = np.arange(Fm.shape[0])
    same = np.all(Fc[alive] == Fm, axis=1)
    flip = np.all(Fc[alive][:, [0, 2, 1]] == Fm, axis=1)
    if not np.all(same | flip):
        raise ValueError("unexpected vertex permutation in the mesh elements")
    swapped = np.zeros(Fc.shape[0], dtype=bool)
    swapped[alive] = ~same
    return alive, swapped, mesh_of_dense


def dense_layout(nx: int, ny: int, mesh):
    """The stencil engine's gate: ``match_dense``'s ``(alive, swapped,
    mesh_of_dense)`` for a mesh on the (nx, ny) rect grid, or ``None`` if
    its nodes are not the uncompacted rect layout, its slot count is not a
    whole number of 1024-slot tiles (the JAX kernels' tile, kept so both
    packages route a mesh alike), or its elements are not an ordered
    subset of the dense grid's."""
    if mesh.n_pnts != (nx + 1) * (ny + 1) + nx * ny or (4 * nx * ny) % 1024 != 0:
        return None
    try:
        return match_dense(nx, ny, mesh._F_np)
    except ValueError:
        return None
