"""Free-slip boundary projection (port of ``mmadmm_tpu/ops/boundary.py``;
reference ``Mesh::projectOntoBoundary``, ``src/Mesh.cpp:119-241``).

Each ``BOUNDARY_FREE`` node goes to its nearest incident boundary face: the
closest point on a boundary edge in 2D (``projection2D``,
``Mesh.cpp:119-174``), the closest in-triangle barycentric projection in
3D (``projection3D``, ``Mesh.cpp:176-233``). The reference comments out
every call site (``Mesh.cpp:636-642, 975-984, 1020-1026``), so this is a
capability the integrators never call: ``MovingMesh.project_onto_boundary``
runs it after a step where the caller asks.

The node-to-incident-face sets (the reference's ``faceConnects``,
``Mesh.cpp:62-112``) are a padded table built on the host; the projection
is a branch-free minimum over the padded face axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.node_type import NodeType

CHECK_EPS = 1e-10  # projection3D's barycentric tolerance


def build_incidence(faces: np.ndarray, mask: np.ndarray):
    """``(node_ids [NB], face_verts [NB, K, D] int32, valid [NB, K])`` for
    the BOUNDARY_FREE nodes, K the most incident boundary faces of any of
    them; unused slots repeat face 0 with ``valid = 0``."""
    free_nodes = np.nonzero(mask == NodeType.BOUNDARY_FREE)[0].astype(np.int32)
    nb = free_nodes.size
    dim = faces.shape[1] if faces.size else 0
    if nb == 0 or faces.size == 0:
        return free_nodes, np.zeros((nb, 0, dim), np.int32), np.zeros((nb, 0))
    incident: dict[int, list[int]] = {int(n): [] for n in free_nodes}
    for fi, fverts in enumerate(faces):
        for v in fverts:
            if int(v) in incident:
                incident[int(v)].append(fi)
    K = max(1, max(len(v) for v in incident.values()))
    table = np.zeros((nb, K), dtype=np.int32)
    valid = np.zeros((nb, K), dtype=np.float64)
    for i, n in enumerate(free_nodes):
        ids = incident[int(n)]
        table[i, :len(ids)] = ids
        valid[i, :len(ids)] = 1.0
    return free_nodes, faces[table], valid


def _pick(cand_d, cand_p, node):
    """The candidate of least distance, or the node where none is finite."""
    best = torch.argmin(cand_d, dim=1)
    rows = torch.arange(cand_d.shape[0], device=cand_d.device)
    d, p = cand_d[rows, best], cand_p[rows, best]
    return torch.where(torch.isfinite(d)[:, None], p, node)


def _project_2d(node, fpts, fvalid):
    """projection2D per incident edge: the segment projection when its sign
    pattern matches the edge direction and 0 < t < 1; endpoint x1 on a
    sign mismatch; endpoint x2 when t > 1; else no candidate."""
    x1, x2 = fpts[:, :, 0], fpts[:, :, 1]  # [NB, K, 2]
    u = x2 - x1
    w = node[:, None, :] - x1
    uu = (u * u).sum(-1)
    alpha = (u * w).sum(-1) / torch.where(uu > 0, uu, 1.0)
    proj = alpha[..., None] * u
    d_proj = torch.linalg.vector_norm(proj - w, dim=-1)
    t = alpha.abs()
    sgns = (torch.sign(u) == torch.sign(proj)).all(-1)
    in_seg = sgns & (t > 0.0) & (t < 1.0)
    p_seg = (1.0 - t)[..., None] * x1 + t[..., None] * x2
    d_x1 = torch.linalg.vector_norm(x1 - node[:, None, :], dim=-1)
    d_x2 = torch.linalg.vector_norm(x2 - node[:, None, :], dim=-1)
    inf = torch.full_like(d_x1, torch.inf)
    cand_d = torch.where(in_seg, d_proj, torch.where(~sgns, d_x1, torch.where(t > 1.0, d_x2, inf)))
    cand_p = torch.where(in_seg[..., None], p_seg, torch.where(
        (~sgns)[..., None], x1, torch.where((t > 1.0)[..., None], x2, x1)))
    cand_d = torch.where(fvalid > 0, cand_d, inf)
    return _pick(cand_d, cand_p, node)


def _project_3d(node, fpts, fvalid):
    """projection3D per incident triangle: the barycentric projection onto
    its plane, a candidate only when every coordinate is at least
    ``CHECK_EPS``; the node stays where none qualifies."""
    q, p1, p2 = fpts[:, :, 0], fpts[:, :, 1], fpts[:, :, 2]  # [NB, K, 3]
    u, v = p1 - q, p2 - q
    n = torch.linalg.cross(u, v)
    nn = (n * n).sum(-1)
    temp = 1.0 / torch.where(nn > 0, nn, 1.0)
    w = node[:, None, :] - q
    b2 = (torch.linalg.cross(u, w) * n).sum(-1) * temp
    b1 = (torch.linalg.cross(w, v) * n).sum(-1) * temp
    b0 = 1.0 - b1 - b2
    proj = b0[..., None] * q + b1[..., None] * p1 + b2[..., None] * p2
    dist = torch.linalg.vector_norm(proj - node[:, None, :], dim=-1)
    ok = (b0 >= CHECK_EPS) & (b1 >= CHECK_EPS) & (b2 >= CHECK_EPS) & (fvalid > 0)
    cand_d = torch.where(ok, dist, torch.full_like(dist, torch.inf))
    return _pick(cand_d, proj, node)


def make_boundary_projector(faces: np.ndarray, mask: np.ndarray, dim: int):
    """``project(x, ref_x=None) -> x'``: each BOUNDARY_FREE node of the
    proposed positions ``x`` moved to its projection onto its incident
    boundary faces at the committed positions ``ref_x`` (the reference
    passes the candidate point but reads the face vertices from ``Vp``,
    ``Mesh.cpp:134-136, 198-200``). ``ref_x`` defaults to ``x``, which is
    degenerate for a node's own faces: pass the positions before the
    step."""
    node_ids_np, fverts_np, valid_np = build_incidence(faces, mask)
    if node_ids_np.size == 0 or fverts_np.shape[1] == 0:
        return lambda x, ref_x=None: x
    proj = _project_2d if dim == 2 else _project_3d

    def project(x, ref_x=None):
        ref_x = x if ref_x is None else ref_x
        ids = torch.as_tensor(node_ids_np, dtype=torch.int64, device=x.device)
        fverts = torch.as_tensor(fverts_np, dtype=torch.int64, device=x.device)
        valid = torch.as_tensor(valid_np, dtype=x.dtype, device=x.device)
        out = x.clone()
        out[ids] = proj(x[ids], ref_x[fverts], valid)
        return out

    return project
