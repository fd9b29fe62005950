"""The benchmark's plain reference of one 3D configuration: the mesh, the
monitor grid and the per-element data, worked out from the configuration
file alone, and the element-major operators that the method's steps
(``steps/<name>.py``) are made of: ``D x`` is ``x[F]`` and ``D^T y`` an
``index_add_`` over the live elements, with no stencil, no slot layout and
no kernel. The prox is the frozen plain K4 (``prox3d.py``), run in slabs
of ``slab`` elements so that it fits beside what it is given.

Nothing here imports the program: it needs torch, numpy and scipy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import huang
from .monitor_grid import build_grid, cell_rows216, gather_cell
from .monitors import get_monitor
from .node_type import NodeType
from .prox3d import prox3d_plain

ADMM_TOL = 1e-3  # the ADMM residual tolerance (main.cpp:184)
PROX_ITERS = 50  # the prox's sweep cap (Mesh.cpp:968)


class Problem:
    """One configuration on ``device`` in ``dtype``: built from the
    configuration's keys and the mesh ``(X, F, mask)`` of
    ``geometry.geometry``."""

    def __init__(self, cfg: dict, mesh, *, dtype=torch.float64, device="cpu",
                 slab: int = 786_432):
        X, F, mask = mesh
        self.dtype, self.device, self.slab = dtype, torch.device(device), int(slab)
        self.dt, self.tau = float(cfg["dt"]), float(cfg["tau"])
        self.w = 0.5 * math.sqrt(float(cfg["rho"]))  # Mesh.cpp:451 (the JSON w is unused)
        self.dt2w2 = self.dt * self.dt * self.w * self.w
        self.admm_iters = int(cfg["AdmmIter"])
        self.grad_use = bool(cfg["GradUse"])
        self.n_pnts, self.n_elements = X.shape[0], F.shape[0]

        def t(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=self.device)

        self.grid = build_grid(X, get_monitor(3, int(cfg["MonType"])), dtype=dtype,
                               device=self.device)
        self.F = t(F, torch.int64)
        self.flat = self.F.reshape(-1)
        deg = np.bincount(F.ravel(), minlength=self.n_pnts).astype(np.float64)
        self.t_node = t(self.tau + self.dt2w2 * deg)[:, None]
        fixed = mask[F] == NodeType.BOUNDARY_FIXED  # [NF, 4]
        self.free = t(np.repeat(~fixed[:, :, None], 3, axis=2).astype(np.float64))
        self.interior = t((mask == NodeType.INTERIOR).astype(np.float64))[:, None]
        self.ehat_np = huang.reference_ehat(3, self.n_elements)
        self.ehat = t(self.ehat_np)

    # ---- the element-major operators --------------------------------
    def gather(self, x):
        """``D x``: ``[NP, 3] -> [NF, 4, 3]``."""
        return x[self.F]

    def scatter(self, y):
        """``D^T y``: ``[NF, 4, 3] -> [NP, 3]``."""
        out = torch.zeros((self.n_pnts, 3), dtype=y.dtype, device=y.device)
        return out.index_add_(0, self.flat, y.reshape(-1, 3))

    def _slabs(self):
        return [slice(a, a + self.slab) for a in range(0, self.n_elements, self.slab)]

    def element_grad(self, x, mask_free: bool):
        """``(I_h, D^T g)``: the energy (float64 sum) and the assembled
        element gradients, each element's masked by ``free`` first when
        ``mask_free``; slab by slab."""
        ih = torch.zeros((), dtype=torch.float64, device=x.device)
        g = torch.zeros((self.n_pnts, 3), dtype=x.dtype, device=x.device)
        for s in self._slabs():
            z = x[self.F[s]]
            ih_e, g_e = huang.element_energy_grad(z, gather_cell(self.grid, z), self.ehat)
            ih = ih + ih_e.sum(dtype=torch.float64)
            if mask_free:
                g_e = g_e * self.free[s]
            g.index_add_(0, self.F[s].reshape(-1), g_e.reshape(-1, 3))
        return ih, g

    def energy(self, x):
        """``I_h(x)``, summed in float64."""
        ih = torch.zeros((), dtype=torch.float64, device=x.device)
        for s in self._slabs():
            z = x[self.F[s]]
            ih = ih + huang.element_energy(z, gather_cell(self.grid, z),
                                           self.ehat).sum(dtype=torch.float64)
        return float(ih)

    def prox(self, z, dxpu):
        """The plain K4 on every element, slab by slab: ``(z', ih0 sum)``."""
        out = torch.empty_like(z)
        ih = torch.zeros((), dtype=torch.float64, device=z.device)
        w, tol = self.w, ADMM_TOL / 100.0
        for s in self._slabs():
            n = z[s].shape[0]

            def ch(a):
                return a.reshape(n, 12).T.contiguous()

            zc = ch(z[s])
            zo, ih0 = prox3d_plain(zc, ch(dxpu[s]), ch(self.free[s]),
                                   cell_rows216(self.grid, zc), self.ehat_np.reshape(-1), w,
                                   tol, PROX_ITERS)
            out[s] = zo.T.reshape(n, 4, 3)
            ih = ih + ih0.sum(dtype=torch.float64)
        return out, ih
