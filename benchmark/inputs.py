"""The seeded inputs of a cell: the configuration's mesh, worked out by the
reference's geometry (``reference/geometry/``), with its
INTERIOR nodes displaced by a seeded amount. Both sides get the same
positions: the program as its initial state, the reference as its start.

The displacement of every node is uniform in ``[-a, a]^D`` with ``a`` the
traffic's ``displacement`` times the smallest grid spacing, drawn on the
device from ``torch.Generator`` seeded with ``--seed``; boundary nodes
stay where they are. Every element must keep its orientation.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.node_type import NodeType
from .reference.geometry import geometry, signed_volumes


def spacing(cfg: dict) -> float:
    """The smallest grid spacing of a box configuration."""
    axes = (("xa", "xb", "nx"), ("ya", "yb", "ny"), ("za", "zb", "nz"))[:int(cfg["Dim"])]
    return min((float(cfg[b]) - float(cfg[a])) / int(cfg[n]) for a, b, n in axes)


def displaced(cfg: dict, fraction: float, seed: int, device):
    """``(mesh, x0)``: the mesh ``(X, F, mask)`` and the seeded start
    positions ``x0 [NP, 3]`` (float64 on ``device``). Raises if an element
    would turn over."""
    X, F, mask = geometry(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    amp = fraction * spacing(cfg)
    d = (2.0 * torch.rand(X.shape, generator=gen, dtype=torch.float64, device=device) - 1.0) * amp
    interior = torch.as_tensor(mask == NodeType.INTERIOR, device=device)[:, None]
    x0 = torch.as_tensor(X, device=device) + torch.where(interior, d, 0.0)
    vol = signed_volumes(x0, torch.as_tensor(F.astype(np.int64), device=device))
    if not bool((vol > 0).all()):
        raise RuntimeError(f"the displacement turned {int((vol <= 0).sum())} elements over")
    return (X, F, mask), x0
