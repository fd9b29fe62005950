"""Shoulder experiment mesh (reference ``setUpShoulderExperiment``,
``main.cpp:403-630``): a rect/box mesh with the (+,+) quadrant removed and
interior nodes randomly perturbed.

This is the geometry behind every ``Monitor1*``/``3DMonitor*`` baseline
config. The random perturbation consumes glibc ``rand()`` seeded with 69
(``main.cpp:785``) through ``Eigen::Vector::Random`` (each coefficient is
``-1 + 2*rand()/RAND_MAX``) and one more draw for the length
(``main.cpp:614-626``); we replicate the stream bit-exactly via
:class:`.glibc_rand.GlibcRand` so initial meshes (and
therefore initial functional values in the recorded baselines) match.

Note the removed elements are dropped from ``F`` but their points are *not*
compacted: orphaned nodes stay in ``X`` with a boundary mark (they have zero
degree and never move; ``main.cpp:519-607``).
"""

from __future__ import annotations

import numpy as np

from .glibc_rand import GlibcRand, RAND_MAX
from .node_type import NodeType
from .rect_mesh import generate_uniform_rect_mesh


def make_shoulder_mesh(
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
    seed: int = 69,
    perturb: bool = True,
):
    """Return ``(X, F, mask)`` for the Shoulder test (main.cpp:403-630)."""
    X, F, mask = generate_uniform_rect_mesh(
        dim, nx, ny, nz, xa, xb, ya, yb, za, zb, boundary_type
    )
    cx = (xa + xb) / 2.0
    cy = (ya + yb) / 2.0
    cz = (za + zb) / 2.0
    EPS = 1e-16
    btype = np.int8(boundary_type)

    V = X[F]  # [NF, D+1, D]
    cent = V.mean(axis=1)
    if dim == 2:
        removed = (cent[:, 0] > cx) & (cent[:, 1] > cy)
    else:
        removed = (cent[:, 0] > cx) & (cent[:, 1] > cy) & (cent[:, 2] > cz)

    # Mark the vertices of removed elements (main.cpp:523-598): boundary_type
    # in general, BOUNDARY_FIXED for the special re-entrant corner points.
    # The reference iterates elements in order, overwriting the mask per
    # vertex, so a later element's verdict wins — but the verdict per vertex
    # depends only on that vertex's coordinates, so order doesn't matter.
    rm = F[removed]  # [NR, D+1]
    vids = rm.ravel()
    P = X[vids]
    if dim == 2:
        fixed = (
            ((np.abs(P[:, 0] - cx) < EPS) & (np.abs(P[:, 1] - cy) < EPS))
            | ((np.abs(P[:, 0] - cx) < EPS) & (np.abs(P[:, 1] - yb) < EPS))
            | ((np.abs(P[:, 0] - xb) < EPS) & (np.abs(P[:, 1] - cy) < EPS))
        )
    else:
        fixed = (
            ((np.abs(P[:, 0] - cx) < EPS) & (np.abs(P[:, 2] - cz) < EPS))
            | ((np.abs(P[:, 0] - cx) < EPS) & (np.abs(P[:, 2] - zb) < EPS))
            | ((np.abs(P[:, 0] - xb) < EPS) & (np.abs(P[:, 2] - cz) < EPS))
            | ((np.abs(P[:, 1] - ya) < EPS) & (np.abs(P[:, 2] - cz) < EPS))
            | ((np.abs(P[:, 1] - yb) < EPS) & (np.abs(P[:, 2] - cz) < EPS))
            | ((np.abs(P[:, 0] - cx) < EPS) & (np.abs(P[:, 1] - ya) < EPS))
            | ((np.abs(P[:, 0] - cx) < EPS) & (np.abs(P[:, 1] - yb) < EPS))
        )
    mask[vids] = np.where(fixed, np.int8(NodeType.BOUNDARY_FIXED), btype)

    F = F[~removed]

    if perturb:
        X = X.copy()
        hx = (xb - xa) / float(nx)
        hy = (yb - ya) / float(ny)
        hz = (zb - za) / float(nz) if dim == 3 else 0.0
        h = np.sqrt(hx * hx + hy * hy + hz * hz)
        rng = GlibcRand(seed)
        # main.cpp:614-626 — per INTERIOR node, in index order: D draws for
        # the direction (Eigen Random in [-1,1]^D, normalized), one for the
        # length r in [0, h/10].
        interior = np.nonzero(mask == NodeType.INTERIOR)[0]
        n_int = interior.size
        draws = rng.rand_array(n_int * (dim + 1)).reshape(n_int, dim + 1)
        dirs = -1.0 + 2.0 * draws[:, :dim] / float(RAND_MAX)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        r = (h / 10.0) * draws[:, dim] / float(RAND_MAX)
        X[interior] += r[:, None] * dirs

    return X, F, mask
