"""Mesh file I/O in the reference's CSV formats (port of
``mmadmm_tpu/geometry/io.py``; reference ``utils::readTriangles``,
``src/MeshUtils.h:669-733``, and the writers of ``main.cpp:131-140,
227-248``): the ``FromFile`` test type's readers and the run artifacts'
writers.

The reference's mask reader appends one spurious trailing entry after EOF
(``MeshUtils.h:704-712``); these read exactly what is there.

The writers give the JAX package's bytes (``", "``-separated rows, floats
as C++'s default ostream, ``%.6g``); they format a block of rows with one
``%`` operation, since a 6.1M-tet mesh has 6.1M rows.
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


_BLOCK = 65536  # rows formatted by one % operation


def _write_rows(path: str, a: np.ndarray, fmt: str) -> None:
    """Rows of ``a`` (2D; 1D as one column), each value as ``fmt``,
    ``", "``-separated, one line each."""
    a = np.asarray(a)
    a = a[:, None] if a.ndim == 1 else a
    row = ", ".join([fmt] * a.shape[1]) + "\n"
    with open(path, "w") as f:
        for s in range(0, a.shape[0], _BLOCK):
            blk = a[s:s + _BLOCK]
            f.write((row * blk.shape[0]) % tuple(blk.ravel().tolist()))


def write_points(path: str, X: np.ndarray) -> None:
    _write_rows(path, np.asarray(X, dtype=np.float64), "%.6g")


def write_triangles(path: str, F: np.ndarray) -> None:
    _write_rows(path, np.asarray(F).astype(np.int64), "%d")


def write_mask(path: str, mask: np.ndarray) -> None:
    _write_rows(path, np.asarray(mask).astype(np.int64).reshape(-1), "%d")


def write_energy_trace(path: str, t_vals, i_vals) -> None:
    """``outputVecToFile`` format: 'time, Ih' rows (main.cpp:131-140)."""
    with open(path, "w") as f:
        for t, ih in zip(t_vals, i_vals):
            f.write(f"{_fmt(t)}, {_fmt(ih)}\n")


def _fmt(v: float) -> str:
    """C++ ostream default formatting for double (6 significant digits)."""
    return f"{float(v):.6g}"
