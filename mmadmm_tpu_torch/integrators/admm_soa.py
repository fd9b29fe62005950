"""MM-ADMM on the 3D stencil engine for SquareGrid and Shoulder box meshes
(port of ``mmadmm_tpu/integrators/admm_soa.py::SoAADMM3D`` in stencil
mode, ``_init_stencil`` and ``_build_step_stencil``).

The box mesh splits each cell into 12 tetrahedra around its centroid and
the Shoulder carve never compacts nodes, so ``D x`` is window slices and
``D^T y`` shifted pad-adds (``ops/stencil3d.py``); the only index
operation left is the monitor cell fetch. The per-element state (z, u) is
channel-major ``[12, NFd]`` over all dense element slots (carved slots
ride along as dead elements: free = 0, masked out of the node sums and
the residuals), the node state ``x [3, NP]``. The JAX package chunks the
element state into ``[C, 12, S]`` slabs for the TPU's (8, 128) tiling;
the card needs no chunks.

Each step is the reference's MM-ADMM step (``MeshIntegrator.cpp``): an
energy-guarded predictor (its gradient in plain batched PyTorch, as in
the JAX package, which has no 3D element-gradient kernel), then at most
``admm_iters`` iterations of prox z-update (kernel K4 in the mesh's
dtype, float32 or float64, one launch over all slots), dual update and
the diagonal x-update, with the primal and dual residual stop. Control flow runs on the host: one synchronisation
per ADMM iteration reads both residuals.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..geometry.topology import node_degrees
from ..mesh import MovingMesh
from ..ops import huang
from ..ops.monitor_grid import cell_rows216, gather_cell
from ..ops.prox3d import prox3d
from ..ops.stencil3d import make_stencil_ops_3d, match_dense_3d
from .admm_base import ADMMBase


class SoA3DState(NamedTuple):
    x: torch.Tensor  # [3, NP]
    x_prev: torch.Tensor
    u: torch.Tensor  # [12, NFd] scaled dual
    steps: int
    ih_last: float
    rose: bool
    rises: int


class SoAADMM3D(ADMMBase):
    """Single-device MM-ADMM integrator on the 3D stencil engine; the step
    is ``ADMMBase``'s."""

    def __init__(
        self,
        mesh: MovingMesh,
        dt: float,
        nx: int,
        ny: int,
        nz: int,
        *,
        admm_iters: int = 10,
        tol: float = 1e-3,
        prox_max_iters: int = 50,
        grad_use: bool = False,
    ):
        NP = mesh.n_pnts
        ncell = nx * ny * nz
        if NP != (nx + 1) * (ny + 1) * (nz + 1) + ncell:
            raise ValueError("node layout is not the uncompacted box grid")
        self.mesh = mesh
        self.dt = float(dt)
        self.admm_iters = int(admm_iters)
        self.tol = float(tol)
        self.prox_tol = self.tol / 100.0  # as the JAX engine's default
        self.prox_max_iters = int(prox_max_iters)
        self.grad_use = bool(grad_use)
        self.NFd = NFd = 12 * ncell

        alive, swapped, mesh_of_dense = match_dense_3d(nx, ny, nz, mesh._F_np)

        def planes(v):  # dense [NFd] -> per-tet cell planes [12, ncell]
            return v.reshape(ncell, 12).T

        free_d = np.zeros((NFd, 12))
        free_d[alive] = mesh._elem_free_np.reshape(-1, 12)[mesh_of_dense[alive]]
        deg = node_degrees(mesh._F_np, NP).astype(np.float64)
        self.tau, self.w = mesh.tau, mesh.w
        self.dt2w2 = self.dt * self.dt * self.w * self.w

        def t(a):
            return torch.as_tensor(
                np.ascontiguousarray(a), dtype=mesh.dtype, device=mesh.device
            )

        self.swap_t = t(planes(swapped.astype(np.float64)))
        self.alive_t = t(planes(alive.astype(np.float64)))
        self.free = t(free_d.T)  # [12, NFd]
        self.valid = t(alive.astype(np.float64))  # [NFd]
        self.t_node = t(self.tau + self.dt2w2 * deg)  # [NP]
        self.x0 = t(mesh._X_np.T)  # [3, NP]
        self._gather_ch, self._scatter_ch = make_stencil_ops_3d(nx, ny, nz)

    # ---- the engine's operators ----------------------------------------
    def init_state(self) -> SoA3DState:
        u = torch.zeros((12, self.NFd), dtype=self.x0.dtype, device=self.x0.device)
        return SoA3DState(x=self.x0, x_prev=self.x0, u=u, steps=0, ih_last=math.inf,
                          rose=False, rises=0)

    def gather(self, x):
        """D x: node field ``[3, NP]`` -> slot values ``[12, NFd]``."""
        return self._gather_ch(x, self.swap_t)

    def scatter(self, y):
        """D^T y over live elements: ``[12, NFd]`` -> ``[3, NP]``."""
        return self._scatter_ch(y, self.swap_t, self.alive_t)

    def x_update(self, x_bar, z, u):
        """The diagonal solve ``(tau I + dt^2 w^2 D^T D) x = tau x_bar +
        dt^2 w^2 D^T (z - u)`` (``MeshIntegrator.cpp:43-58``)."""
        rhs = self.tau * x_bar + self.dt2w2 * self.scatter(z - u)
        return rhs / self.t_node[None, :]

    def cells(self, z):
        """The four per-vertex cell rows of every slot, ``[216, NFd]``,
        fetched at the current z."""
        return cell_rows216(self.mesh.grid, z)

    def prox(self, z, dxpu):
        """Kernel K4 on this step's slots: ``(z', ih0)``."""
        return prox3d(
            z, dxpu.contiguous(), self.free, self.cells(z),
            self.mesh.ehat_np.reshape(-1), self.w, self.prox_tol,
            self.prox_max_iters,
        )

    def euler_grad(self, x):
        """The free-masked assembled gradient ``[3, NP]`` for the predictor
        (``Mesh::eulerGrad``): stencil gather, the batched element
        gradient, stencil scatter (``grad_full``, ``admm_soa.py:719-738``)."""
        z = self.gather(x).T.reshape(self.NFd, 4, 3)
        _, g = huang.element_energy_grad(z, gather_cell(self.mesh.grid, z), self.mesh.ehat)
        return self.scatter((g.reshape(self.NFd, 12) * self.free.T).T)

    def energy(self, state: SoA3DState) -> float:
        return float(self.mesh.energy(state.x.T))
