"""MM-ADMM on the structured-grid (stencil) engine for 2D SquareGrid and
Shoulder meshes (port of ``mmadmm_tpu/integrators/admm_grid2d.py``).

The mesh is a uniform rect grid with cell midpoints, each cell split into
4 triangles (``MeshUtils.h:104-155``); the Shoulder carve drops elements
without compacting nodes (``main.cpp:519-607``). So ``D x`` is window
slices and ``D^T y`` shifted pad-adds (``ops/stencil2d.py``), and the only
index operation left is the monitor cell-table fetch. The per-element
state (z, u) is channel-major ``[6, NFd]`` over all dense element slots;
carved slots ride along as dead elements (free = 0, masked out of the node
sums and the residuals).

Reorientation swaps (v1 <-> v2 on negative-det triangles) come from the
mesh's actual F, so the prox inputs equal those of the compact path.

Each step is ``admm_base.ADMMBase``'s MM-ADMM step, its prox kernel K1 in
the mesh's dtype (float32 or float64, as the JAX engine builds its kernel
in the mesh's dtype); the energy and residual sums are float64 either way
(``ops/reductions.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..geometry.topology import node_degrees
from ..mesh import MovingMesh
from ..ops.monitor_grid import cell_rows48
from ..ops.prox2d import prox2d
from ..ops.stencil2d import make_stencil_ops, match_dense
from .admm_base import ADMMBase


class Grid2DState(NamedTuple):
    x: torch.Tensor  # [NP, 2]
    x_prev: torch.Tensor
    u: torch.Tensor  # [6, NFd] scaled dual
    steps: int
    ih_last: float
    rose: bool
    rises: int


class GridADMM2D(ADMMBase):
    """Single-device MM-ADMM integrator on the stencil engine."""

    def __init__(
        self,
        mesh: MovingMesh,
        dt: float,
        nx: int,
        ny: int,
        *,
        admm_iters: int = 10,
        tol: float = 1e-3,
        prox_max_iters: int = 50,
        grad_use: bool = False,
    ):
        NP = mesh.n_pnts
        stride = (nx + 1) * (ny + 1)
        if NP != stride + nx * ny:
            raise ValueError("node layout is not the uncompacted rect grid")
        self.mesh = mesh
        self.dt = float(dt)
        self.admm_iters = int(admm_iters)
        self.tol = float(tol)
        self.prox_tol = self.tol / 100.0  # as the JAX engine's default
        self.prox_max_iters = int(prox_max_iters)
        self.grad_use = bool(grad_use)
        self.NFd = NFd = 4 * nx * ny

        alive, swapped, mesh_of_dense = match_dense(nx, ny, mesh._F_np)

        def planes(v):  # dense [NFd] -> per-k cell planes [4, ny, nx]
            return v.reshape(ny, nx, 4).transpose(2, 0, 1)

        free_d = np.zeros((NFd, 6))
        free_d[alive] = mesh._elem_free_np.reshape(-1, 6)[mesh_of_dense[alive]]
        deg = node_degrees(mesh._F_np, NP).astype(np.float64)
        self.tau, self.w = mesh.tau, mesh.w
        self.dt2w2 = self.dt * self.dt * self.w * self.w

        def t(a):
            return torch.as_tensor(
                np.ascontiguousarray(a), dtype=mesh.dtype, device=mesh.device
            )

        self.swap_k = t(planes(swapped.astype(np.float64)))
        self.alive_k = t(planes(alive.astype(np.float64)))
        self.free = t(free_d.T)  # [6, NFd]
        self.valid = t(alive.astype(np.float64))  # [NFd]
        self.t_diag = t(self.tau + self.dt2w2 * deg)
        self._gather_ch, self._scatter_ch = make_stencil_ops(nx, ny)

    # ---- the engine's operators ----------------------------------------
    def init_state(self) -> Grid2DState:
        x0 = self.mesh.X0
        u = torch.zeros((6, self.NFd), dtype=x0.dtype, device=x0.device)
        return Grid2DState(x=x0, x_prev=x0, u=u, steps=0, ih_last=math.inf,
                           rose=False, rises=0)

    def gather(self, x):
        """D x: node field ``[NP, 2]`` -> slot values ``[6, NFd]``."""
        return self._gather_ch(x, self.swap_k)

    def scatter(self, y):
        """D^T y over live elements: ``[6, NFd]`` -> ``[NP, 2]``."""
        return self._scatter_ch(y, self.swap_k, self.alive_k)

    def x_update(self, x_bar, z, u):
        """The diagonal solve ``(tau I + dt^2 w^2 D^T D) x = tau x_bar +
        dt^2 w^2 D^T (z - u)`` (``MeshIntegrator.cpp:43-58``)."""
        rhs = self.tau * x_bar + self.dt2w2 * self.scatter(z - u)
        return rhs / self.t_diag[:, None]

    def cells(self, z):
        """The three per-vertex cell-table rows of every slot,
        ``[48, NFd]``, fetched at the current z."""
        return cell_rows48(self.mesh.grid, z)

    def prox(self, z, dxpu):
        """Kernel K1 on this step's slots: ``(z', ih0)``."""
        return prox2d(
            z, dxpu.contiguous(), self.free, self.cells(z),
            self.mesh.ehat_np.reshape(-1), self.w, self.prox_tol,
            self.prox_max_iters,
        )

    def euler_grad(self, x):
        """Predictor gradient on the compact mesh path (runs in the first
        steps and after energy rises only)."""
        return self.mesh.gradient(x)[1]

    def energy(self, state: Grid2DState) -> float:
        return float(self.mesh.energy(state.x))
