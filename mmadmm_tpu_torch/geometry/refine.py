"""Uniform 1:4 midpoint refinement of triangle meshes (port of
``mmadmm_tpu/geometry/refine.py::refine_triangle_mesh``; NumPy, its arrays
bit-equal to the JAX package's, ``tests/test_torch_geometry_levelset.py``).
The JAX module's ``make_circle_ex192r``, which wrote the shipped
``Monitor3320r`` inputs from the reference's files once, has no
counterpart: those files are in ``Experiments/``.

The reference's BaseCircle mesh series (``Experiments/Results/BaseCircle/
CircleEx{6..192}*``) was produced by an external mesher that is not in the
repository, and the finest level's geometry files (``CircleEx192points/
triangles.txt``) are MISSING from the shipped reference — only its mask
survived (133,725 rows), so the recorded ``Monitor3320`` baseline config
cannot be run by the reference binary today either. This utility provides
the nearest reproducible stand-in: midpoint subdivision of the shipped
``CircleEx96`` mesh (V=33,433, F=66,251 → V=133,116, F=265,004 — within
0.5% of the lost mesh's node count), with boundary-edge midpoints
projected onto the unit circle and marked ``BOUNDARY_FIXED`` like their
endpoints (the reference circle meshes carry their r=1 nodes as fixed,
``main.cpp:735-782`` FromFile semantics).
"""

from __future__ import annotations

import numpy as np

from .node_type import NodeType


def refine_triangle_mesh(
    X: np.ndarray,
    F: np.ndarray,
    mask: np.ndarray,
    project_boundary_to_unit_circle: bool = False,
):
    """1:4 midpoint subdivision. Returns (X', F', mask').

    Every triangle (a, b, c) splits into (a, mab, mac), (b, mbc, mab),
    (c, mac, mbc), (mab, mbc, mac) — the standard loop-topology split,
    orientation-preserving. Midpoints of BOUNDARY edges (edges on exactly
    one triangle) inherit BOUNDARY_FIXED; all other midpoints are
    INTERIOR.
    """
    X = np.asarray(X, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    mask = np.asarray(mask)
    nv = X.shape[0]

    # unique undirected edges + per-triangle edge slots (ab, bc, ac)
    tri_edges = np.stack(
        [F[:, [0, 1]], F[:, [1, 2]], F[:, [0, 2]]], axis=1
    ).reshape(-1, 2)
    tri_edges_sorted = np.sort(tri_edges, axis=1)
    edges, inv = np.unique(tri_edges_sorted, axis=0, return_inverse=True)
    inv = inv.reshape(-1, 3)  # [NF, 3] edge ids for (ab, bc, ac)

    mid = 0.5 * (X[edges[:, 0]] + X[edges[:, 1]])
    counts = np.bincount(inv.ravel(), minlength=len(edges))
    bnd_edge = counts == 1
    if project_boundary_to_unit_circle:
        r = np.hypot(mid[bnd_edge, 0], mid[bnd_edge, 1])
        mid[bnd_edge] = mid[bnd_edge] / r[:, None]

    Xn = np.concatenate([X, mid])
    mab = nv + inv[:, 0]
    mbc = nv + inv[:, 1]
    mac = nv + inv[:, 2]
    a, b, c = F[:, 0], F[:, 1], F[:, 2]
    Fn = np.concatenate(
        [
            np.stack([a, mab, mac], axis=1),
            np.stack([b, mbc, mab], axis=1),
            np.stack([c, mac, mbc], axis=1),
            np.stack([mab, mbc, mac], axis=1),
        ]
    )
    mid_mask = np.full(
        len(edges), int(NodeType.INTERIOR), dtype=mask.dtype
    )
    mid_mask[bnd_edge] = int(NodeType.BOUNDARY_FIXED)
    maskn = np.concatenate([mask, mid_mask])
    return Xn, Fn.astype(np.int32), maskn
