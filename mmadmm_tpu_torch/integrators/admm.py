"""MM-ADMM on the stock element-major engine (port of
``mmadmm_tpu/integrators/admm.py::ADMMIntegrator``, single device, with
``prox_backend="pallas"``; reference ``MeshIntegrator<D>``).

It takes any mesh, structured or not: the per-element state (z, u) is
element-major ``[NF, D+1, D]``, ``D x`` a gather ``x[F]`` and ``D^T y``
the degree-padded sum (``ops/scatter.py``). The prox is a kernel behind
its element-major entry, which fetches the cells at z and moves the
blocks to channels and back: K1 in 2D (``ops/prox2d.py::prox_elements``),
K4' on a 3D computational mesh and K4 on any other 3D mesh
(``ops/prox3d.py::prox_elements``). The predictor's gradient is
``MovingMesh.gradient``, the batched Huang gradient with the mesh's Ehat
(per element on a computational mesh).

Each step is ``admm_base.ADMMBase``'s. The JAX state's chord Jacobian
``J`` and its ``j_fresh`` flag are dead under the kernel backend
(``admm.py:131-147`` in the JAX package: the kernels build their Hessians
themselves) and are not carried.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..mesh import MovingMesh
from ..ops import prox2d, prox3d
from .admm_base import ADMMBase


class ADMMState(NamedTuple):
    x: torch.Tensor  # [NP, D]
    x_prev: torch.Tensor
    u: torch.Tensor  # [NF, D+1, D] scaled dual (the JAX state's u_bar)
    steps: int
    ih_last: float
    rose: bool
    rises: int


class ADMMIntegrator(ADMMBase):
    """Single-device MM-ADMM integrator on element-major blocks."""

    def __init__(
        self,
        mesh: MovingMesh,
        dt: float,
        *,
        admm_iters: int = 10,
        tol: float = 1e-3,
        prox_max_iters: int = 50,
        grad_use: bool = False,
    ):
        if mesh.dtype != torch.float32:
            raise NotImplementedError(
                "the prox kernels are float32; float64 runs need the generic "
                "prox (ROADMAP item A10)"
            )
        self.mesh = mesh
        self.dt = float(dt)
        self.admm_iters = int(admm_iters)
        self.tol = float(tol)
        self.prox_tol = self.tol / 100.0  # as the JAX engine's default
        self.prox_max_iters = int(prox_max_iters)
        self.grad_use = bool(grad_use)
        self.tau, self.w = mesh.tau, mesh.w
        self.dt2w2 = self.dt * self.dt * self.w * self.w
        self.free = mesh.elem_free  # [NF, D+1, D]
        self.valid = torch.ones((mesh.n_elements, 1, 1), dtype=mesh.dtype, device=mesh.device)
        self.t_diag = self.tau + self.dt2w2 * mesh.deg  # [NP]

    def init_state(self) -> ADMMState:
        x0 = self.mesh.X0
        D = self.mesh.dim
        u = torch.zeros((self.mesh.n_elements, D + 1, D), dtype=x0.dtype, device=x0.device)
        return ADMMState(x=x0, x_prev=x0, u=u, steps=0, ih_last=math.inf, rose=False,
                         rises=0)

    # ---- the engine's operators ----------------------------------------
    def gather(self, x):
        """D x: ``[NP, D] -> [NF, D+1, D]``."""
        return self.mesh.gather(x)

    def scatter(self, y):
        """D^T y: ``[NF, D+1, D] -> [NP, D]``."""
        return self.mesh.scatter_add(y)

    def x_update(self, x_bar, z, u):
        """The diagonal solve ``(tau I + dt^2 w^2 D^T D) x = tau x_bar +
        dt^2 w^2 D^T (z - u)`` (``MeshIntegrator.cpp:43-58``)."""
        rhs = self.tau * x_bar + self.dt2w2 * self.scatter(z - u)
        return rhs / self.t_diag[:, None]

    def prox(self, z, dxpu):
        """The prox kernel on every element: ``(z', ih0)``."""
        mesh = self.mesh
        args = (self.w, self.prox_tol, self.prox_max_iters)
        if mesh.dim == 2:
            return prox2d.prox_elements(mesh.grid, z, dxpu, self.free,
                                        mesh.ehat_np.reshape(-1), *args)
        return prox3d.prox_elements(mesh.grid, z, mesh.xi, dxpu, self.free, *args,
                                    ehat=mesh.ehat_np.reshape(-1))

    def euler_grad(self, x):
        """The free-masked assembled gradient ``[NP, D]`` for the
        predictor (``Mesh::eulerGrad``)."""
        return self.mesh.gradient(x)[1]

    def energy(self, state: ADMMState) -> float:
        return float(self.mesh.energy(state.x))
