"""Frozen copy of ``mmadmm_tpu_torch/runtime/nn.py`` for the benchmark's reference.

Nearest-vertex map for the monitor background grid (SciPy).

Counterpart of ``mmadmm_tpu/runtime/native.py::grid_nn_map``, whose
native grid hash (``native/mmnative.cpp::mm_grid_nn_map``) takes, for
every grid node ``p = lo + g * (hi - lo) / n``, the vertex with the least
squared distance ``sum_d (X[v, d] - p[d])^2`` (float64, d in order) and,
among equal distances, the least index. On a uniform mesh many grid nodes
lie exactly between vertices (all the more in 3D), so the tie rule
decides the monitor grid. The port finds candidates with SciPy's
``cKDTree`` and applies the same distance and tie rule, so it needs no
native build (``tests/test_torch_setup.py`` and
``tests/test_torch_ops3d.py`` hold the maps and the cell tables equal).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

_K = 16  # candidates per grid node, doubled where they all tie


def grid_nn_map(X: np.ndarray, lo: np.ndarray, hi: np.ndarray, n: int) -> np.ndarray:
    """Index of the nearest vertex of ``X`` for every node of the
    ``(n+1)^D`` grid over ``[lo, hi]``, x fastest, least index on ties.
    Returns int64."""
    X = np.ascontiguousarray(X, dtype=np.float64)
    D = X.shape[1]
    span = np.asarray(hi, dtype=np.float64) - np.asarray(lo, dtype=np.float64)
    step = np.where(span > 0, span, 1.0) / n
    axes = [lo[d] + np.arange(n + 1, dtype=np.float64) * step[d] for d in range(D)]
    grids = np.meshgrid(*axes[::-1], indexing="ij")[::-1]  # x fastest
    q = np.stack([g.ravel() for g in grids], axis=1)
    tree = cKDTree(X)

    def dsq(p, idx):  # [Q, D], [Q, K] -> [Q, K], the native library's sum
        s = (X[idx, 0] - p[:, None, 0]) ** 2
        for d in range(1, D):
            s = s + (X[idx, d] - p[:, None, d]) ** 2
        return s

    nn = np.empty(q.shape[0], dtype=np.int64)
    rows, k = np.arange(q.shape[0]), min(_K, X.shape[0])
    while rows.size:
        _, idx = tree.query(q[rows], k=k, workers=-1)  # every core; the same result
        idx = idx.reshape(rows.size, k)
        dist = dsq(q[rows], idx)
        best = dist.min(1)
        nn[rows] = np.where(dist == best[:, None], idx, X.shape[0]).min(1)
        if k == X.shape[0]:
            break
        # where all k candidates are within round-off of the best, more may tie
        rows = rows[dist.max(1) <= best * (1.0 + 1e-9)]
        k = min(2 * k, X.shape[0])
    return nn
