"""Nearest-vertex map for the monitor background grid (SciPy).

Counterpart of ``mmadmm_tpu/runtime/native.py::grid_nn_map``. The JAX
package prefers its native grid-hash library and falls back to SciPy's
``cKDTree``; the port uses ``cKDTree`` alone, so it needs no native build.
Both give the same map at Shoulder nx=16 and nx=320
(``tests/test_torch_setup.py`` checks the cell tables they lead to).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def grid_nn_map(X: np.ndarray, lo: np.ndarray, hi: np.ndarray, n: int) -> np.ndarray:
    """Index of the nearest vertex of ``X`` for every node of the
    ``(n+1)^D`` grid over ``[lo, hi]``, x fastest. Returns int64."""
    X = np.ascontiguousarray(X, dtype=np.float64)
    D = X.shape[1]
    axes = [lo[d] + np.arange(n + 1) * (hi[d] - lo[d]) / n for d in range(D)]
    if D == 2:
        gx, gy = np.meshgrid(axes[0], axes[1], indexing="xy")
        q = np.stack([gx.ravel(), gy.ravel()], axis=1)
    else:
        gz, gy, gx = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
        q = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
    _, nn = cKDTree(X).query(q)
    return nn.astype(np.int64)
