"""Level-set domain carving (port of ``mmadmm_tpu/geometry/level_set.py``;
reference ``utils::meshFromLevelSetFun``, ``src/MeshUtils.h:404-667``)
plus the built-in level-set geometries from ``main.cpp:33-129``. NumPy;
its arrays are bit-equal to the JAX package's
(``tests/test_torch_geometry_levelset.py``).

Pipeline (2D, ``MeshUtils.h:404-538``): generate the uniform rect mesh on the
bounding box; drop every element whose D+1 vertices all have
``phi > -EPS``; project each remaining node with ``phi >= 0`` (or
``|phi| < EPS``) onto the zero level set along the normal
(``interpolateBoundaryLocation``, ``MeshUtils.h:369-402``); compact and
renumber the used points; finally mark nodes with ``|phi| < EPS`` as
``BOUNDARY_FIXED``.

Deviations from the reference (documented, intentional):
  * the reference's boundary-mask array is *not* remapped through the point
    compaction (``MeshUtils.h:493-537`` marks old indices but reads new
    ones), leaving scrambled stale marks; we remap the mask correctly.
  * the reference's 3D variant (``MeshUtils.h:540-667``) assigns the
    compacted arrays to local pointers (a leak — the caller never sees
    them) and compacts indices in *descending* order; we implement 3D the
    same way as 2D (correct, ascending).
  * the reference's 2D projection normal is hard-coded to the radial
    direction of the circle test (``MeshUtils.h:378-381``); we keep that
    behavior when ``normal="circle"`` (default for the circle phi, for
    parity with the shipped BaseCircle meshes) and otherwise use the
    central-difference gradient like the 3D path.
"""

from __future__ import annotations

import numpy as np

from .node_type import NodeType
from .rect_mesh import generate_uniform_rect_mesh

_EPS = 1e-12
_H = 2.0 * np.sqrt(np.finfo(np.float64).eps)


# ---------------------------------------------------------------------------
# Built-in level-set geometries (main.cpp:33-129). All vectorized over [N, D].
# ---------------------------------------------------------------------------

def circle_phi(p: np.ndarray) -> np.ndarray:
    """Circle r=0.35 centered (0.5, 0.5) (main.cpp:33-40)."""
    return np.sqrt((p[..., 0] - 0.5) ** 2 + (p[..., 1] - 0.5) ** 2) - 0.35


def sphere_phi(p: np.ndarray) -> np.ndarray:
    """Sphere r=0.4 centered (0.5,)*3, squared form (main.cpp:87-97)."""
    return (
        (p[..., 0] - 0.5) ** 2
        + (p[..., 1] - 0.5) ** 2
        + (p[..., 2] - 0.5) ** 2
        - 0.4**2
    )


def blood_cell_phi_2d(p: np.ndarray) -> np.ndarray:
    """Cassini-oval blood cell (main.cpp:42-61)."""
    cx, cy, a, c, r, deg = 0.6, 0.6, 0.3, 0.105, 0.5, 47.0
    b = 2.25 * r
    rad = deg * np.pi / 180.0
    x, y = p[..., 0], p[..., 1]
    rotcx = (x - cx) / b * np.cos(rad) - (y - cy) / b * np.sin(rad)
    rotcy = (x - cx) / b * np.sin(rad) + (y - cy) / b * np.cos(rad)
    x2, y2 = rotcx**2, rotcy**2
    return (x2 + y2 + a**2) ** 2 - 4 * a**2 * x2 - c**2


def blood_cell_phi_3d(p: np.ndarray) -> np.ndarray:
    """3D Cassini oval (main.cpp:64-85)."""
    cx, cy, cz, a, c, r, deg = 2.5, 4.0, 2.5, 0.3, 0.105, 0.5, 0.0
    b = 1.75 * r
    rad = deg * np.pi / 180.0
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rotcy = (y - cy) / b * np.cos(rad) - (z - cz) / b * np.sin(rad)
    rotcz = (y - cy) / b * np.sin(rad) + (z - cz) / b * np.cos(rad)
    x2 = ((x - cx) / b) ** 2
    y2, z2 = rotcy**2, rotcz**2
    return (x2 + y2 + z2 + a**2) ** 2 - 4 * a**2 * (x2 + y2) - c**2


def heart_phi(p: np.ndarray) -> np.ndarray:
    """Heart curve (main.cpp:99-107)."""
    x = p[..., 0] - 0.5
    y = p[..., 1] - 2.4
    ax = np.abs(x)
    return (y - (2.0 * (ax + x**2 - 6)) / (3.0 * (ax + x**2 + 2))) ** 2 + x**2 - 0.1


def shoulder_phi(p: np.ndarray) -> np.ndarray:
    """Superellipse shoulder (main.cpp:110-129; marked 'Doesnt work')."""
    n = 500.0
    phi1 = (p[..., 0] - 0.5) ** n + (p[..., 1] - 0.5) ** n - 0.4**n
    phi2 = (p[..., 0] - 0.675) ** n + (p[..., 1] - 0.675) ** n - 0.2**n
    return np.maximum(phi1, phi2)


# ---------------------------------------------------------------------------


def _project_to_level_set(pts: np.ndarray, phi_fun, normal: str) -> np.ndarray:
    """pnt <- pnt - phi(pnt) * n(pnt)  (MeshUtils.h:369-402)."""
    if pts.size == 0:
        return pts
    D = pts.shape[1]
    if normal == "circle":
        # hard-coded radial normal of the circle test (MeshUtils.h:378-381)
        v = pts - 0.5
        n = v / np.linalg.norm(v, axis=1, keepdims=True)
    else:
        g = np.empty_like(pts)
        for d in range(D):
            ep = pts.copy()
            em = pts.copy()
            ep[:, d] += _H
            em[:, d] -= _H
            g[:, d] = (phi_fun(ep) - phi_fun(em)) / (2.0 * _H)
        n = g / np.linalg.norm(g, axis=1, keepdims=True)
    return pts - phi_fun(pts)[:, None] * n


def mesh_from_level_set(
    phi_fun,
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
    normal: str = "circle",
):
    """Carve a mesh out of the zero sublevel set of ``phi_fun``.

    Returns ``(X, F, mask)`` with compacted point numbering.
    """
    X, F, mask = generate_uniform_rect_mesh(
        dim, nx, ny, nz, xa, xb, ya, yb, za, zb, boundary_type
    )
    # the reference resets everything to INTERIOR before carving
    # (MeshUtils.h:437-439)
    mask = np.full(X.shape[0], NodeType.INTERIOR, dtype=np.int8)

    phi_v = phi_fun(X)  # [NP]
    # Drop elements with all vertices outside (phi > -EPS) (MeshUtils.h:448-461)
    keep = ~np.all(phi_v[F] > -_EPS, axis=1)
    F = F[keep]

    used = np.unique(F)  # sorted ascending, like the 2D reference
    on_or_out = (np.abs(phi_v[used]) < _EPS) | (phi_v[used] > 0)
    proj_ids = used[on_or_out]
    X[proj_ids] = _project_to_level_set(X[proj_ids], phi_fun, normal)
    mask[proj_ids] = boundary_type

    # Compact (MeshUtils.h:493-524), remapping the mask too (reference bug
    # fixed: it marks old indices but never remaps the mask array).
    remap = np.full(X.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(used.size)
    Xc = X[used]
    maskc = mask[used]
    Fc = remap[F].astype(np.int32)

    # Final fixed-boundary marking (MeshUtils.h:529-537)
    phi_c = phi_fun(Xc)
    maskc[np.abs(phi_c) < _EPS] = NodeType.BOUNDARY_FIXED
    return Xc, Fc, maskc
