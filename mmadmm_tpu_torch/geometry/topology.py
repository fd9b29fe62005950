"""Mesh topology (NumPy): orientation, node degrees, the sorted and the
degree-padded ``D^T`` plans, boundary faces and the element partition.

Copy of the 2D/3D helpers of ``mmadmm_tpu/geometry/topology.py``
(reference ``src/Mesh.cpp:62-112,244-260``).
"""

from __future__ import annotations

import numpy as np

from .node_type import NodeType


def element_edge_dets(X: np.ndarray, F: np.ndarray) -> np.ndarray:
    """det of the edge matrix E = [x1-x0, ..., xD-x0] per element."""
    V = X[F]  # [NF, D+1, D]
    E = V[:, 1:, :] - V[:, :1, :]  # rows are edges; det(E^T) == det(E)
    D = X.shape[1]
    if D == 2:
        return E[:, 0, 0] * E[:, 1, 1] - E[:, 0, 1] * E[:, 1, 0]
    if D == 3:
        a, b, c = E[:, 0], E[:, 1], E[:, 2]
        return np.einsum("ij,ij->i", a, np.cross(b, c))
    raise ValueError("D must be 2 or 3")


def reorient_elements(X: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Swap columns 1 and 2 of negatively-oriented elements
    (``Mesh.cpp:244-260``; det(A^T) = det(A), so rows or columns as edges
    give the same sign test)."""
    F = F.copy()
    neg = element_edge_dets(X, F) < 0
    F[neg, 1], F[neg, 2] = F[neg, 2].copy(), F[neg, 1].copy()
    return F


def node_degrees(F: np.ndarray, n_pnts: int) -> np.ndarray:
    """Number of (element, slot) references per node: the diagonal of
    ``D^T D``, which makes the ADMM x-update matrix diagonal."""
    return np.bincount(F.ravel(), minlength=n_pnts).astype(np.int32)


def sorted_scatter_plan(F: np.ndarray, n_pnts: int):
    """Sort-based ``D^T`` layout: ``(perm, seg_ids)``, where ``perm``
    permutes the flat ``[NF*(D+1)]`` slot axis into node-sorted order and
    ``seg_ids`` are the node ids in that order (``topology.py:58-72``)."""
    flat = F.ravel()
    perm = np.argsort(flat, kind="stable").astype(np.int32)
    return perm, flat[perm].astype(np.int32)


def dense_scatter_plan(F: np.ndarray, n_pnts: int):
    """Degree-padded gather plan for ``D^T``.

    Returns ``(idx [NP, K] int32, K)``: row p lists the flat element-slot
    positions (into ``[NF*(D+1)]``) that reference node p, padded with
    ``NF*(D+1)`` (a zero row the caller appends). ``D^T y`` is then
    ``y_padded[idx].sum(1)``, a deterministic sum in slot order."""
    flat = F.ravel()
    order = np.argsort(flat, kind="stable")
    seg = flat[order]
    counts = np.bincount(flat, minlength=n_pnts)
    K = int(counts.max()) if counts.size else 0
    idx = np.full((n_pnts, K), flat.size, dtype=np.int32)
    starts = np.zeros(n_pnts + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    ranks = np.arange(flat.size) - starts[seg]
    idx[seg, ranks] = order.astype(np.int32)
    return idx, K


def build_boundary_faces(F: np.ndarray, mask: np.ndarray):
    """Boundary faces: elements with exactly D non-INTERIOR vertices give
    the face of those vertices, in slot order (``Mesh.cpp:73-104``)."""
    Dp1 = F.shape[1]
    non_int = mask[F] != NodeType.INTERIOR  # [NF, D+1]
    rows = np.nonzero(non_int.sum(axis=1) == Dp1 - 1)[0]
    if rows.size == 0:
        return np.zeros((0, Dp1 - 1), dtype=np.int32)
    faces = F[rows][non_int[rows]].reshape(rows.size, Dp1 - 1)
    return faces.astype(np.int32)


def partition_elements(X: np.ndarray, F: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection over element centroids
    (``topology.py:115-138``): a permutation of the element indices whose
    contiguous equal-size chunks are spatially compact; any ``n_parts``
    works, by uneven median splits."""
    cent = X[F].mean(axis=1)  # [NF, D]

    def rcb(idx: np.ndarray, k: int) -> np.ndarray:
        if k <= 1 or idx.size <= 1:
            return idx
        spans = cent[idx].max(axis=0) - cent[idx].min(axis=0)
        ax = int(np.argmax(spans))
        kl = k // 2
        n_left = (idx.size * kl) // k
        part = np.argpartition(cent[idx, ax], max(n_left - 1, 0))
        return np.concatenate([rcb(idx[part[:n_left]], kl), rcb(idx[part[n_left:]], k - kl)])

    return rcb(np.arange(F.shape[0]), n_parts).astype(np.int32)
