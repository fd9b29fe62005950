"""Mesh file readers in the reference's CSV formats (port of
``mmadmm_tpu/geometry/io.py``; reference ``utils::readTriangles``,
``src/MeshUtils.h:669-733``): the ``FromFile`` test type.

The reference's mask reader appends one spurious trailing entry after EOF
(``MeshUtils.h:704-712``); these read exactly what is there.
"""

from __future__ import annotations

import numpy as np


def read_points(path: str) -> np.ndarray:
    return np.loadtxt(path, delimiter=",", ndmin=2, dtype=np.float64)


def read_triangles(path: str) -> np.ndarray:
    return np.loadtxt(path, delimiter=",", ndmin=2, dtype=np.int64).astype(np.int32)


def read_mask(path: str, n_pnts: int | None = None) -> np.ndarray:
    vals = np.loadtxt(path, ndmin=1, dtype=np.int64).astype(np.int8)
    if n_pnts is not None:
        vals = vals[:n_pnts]
    return vals


def read_mesh(tri_path: str, pnts_path: str, mask_path: str):
    """``(X, F, mask)`` of a FromFile experiment (``main.cpp:771-776``)."""
    F = read_triangles(tri_path)
    X = read_points(pnts_path)
    mask = read_mask(mask_path, X.shape[0])
    return X, F, mask
