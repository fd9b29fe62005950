"""MM-ADMM on the stock element-major engine (port of
``mmadmm_tpu/integrators/admm.py::ADMMIntegrator``, single device;
reference ``MeshIntegrator<D>``).

It takes any mesh, structured or not: the per-element state (z, u) is
element-major ``[NF, D+1, D]``, ``D x`` a gather ``x[F]`` and ``D^T y``
the degree-padded sum (``ops/scatter.py``). The prox is the mesh's
(``MovingMesh.prox_fn``): on the kernel route (``prox_backend="pallas"``)
a kernel behind its element-major entry, which fetches the cells at z and
moves the blocks to channels and back (K1 in 2D, K4, K4' or K4'' in 3D);
on the generic route (``"vmap"``, every float64 run and every 2D
computational mesh) the batched Newton prox of ``ops/prox.py`` in the
mesh's dtype. The predictor's gradient is ``MovingMesh.gradient``, the
batched Huang gradient with the mesh's Ehat (per element on a
computational mesh).

On the generic route the state carries the prox's chord Jacobian ``J
[NF, n, n]`` across prox calls and time steps (``admm.py:65-75, :124-160``
in the JAX package): the first prox call of a run builds it
(``j_fresh``), and the prox's refreshes keep it current. ``j_carry=None``
carries it while it takes at most 400 MiB; without the carry each prox
call builds its own entry Jacobian and ``J`` is an empty ``[NF, 0, 0]``.
The kernels build their Hessians themselves, so the kernel route never
carries it (``j_carry=True`` raises there).

Each step is ``admm_base.ADMMBase``'s.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..mesh import MovingMesh
from .admm_base import ADMMBase

J_CARRY_MAX_BYTES = 400 * 2**20


class ADMMState(NamedTuple):
    x: torch.Tensor  # [NP, D]
    x_prev: torch.Tensor
    u: torch.Tensor  # [NF, D+1, D] scaled dual (the JAX state's u_bar)
    steps: int
    ih_last: float
    rose: bool
    rises: int
    J: torch.Tensor  # [NF, n, n] the carried chord Jacobian ([NF, 0, 0] without the carry)
    j_fresh: bool  # J is built anew at the next prox call


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
        j_carry: bool | None = None,
    ):
        if mesh.prox_backend == "pallas":
            if j_carry:
                raise ValueError("j_carry=True needs the generic prox (prox_backend='vmap'): "
                                 "the prox kernels build their Hessians themselves")
            j_carry = False
        elif j_carry is None:
            n = mesh.dim * (mesh.dim + 1)
            itemsize = torch.finfo(mesh.dtype).bits // 8
            j_carry = mesh.n_elements * n * n * itemsize <= J_CARRY_MAX_BYTES
        self.j_carry = bool(j_carry)
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
        nf = self.mesh.n_elements
        u = torch.zeros((nf, D + 1, D), dtype=x0.dtype, device=x0.device)
        n = D * (D + 1) if self.j_carry else 0
        J = torch.zeros((nf, n, n), dtype=x0.dtype, device=x0.device)
        return ADMMState(x=x0, x_prev=x0, u=u, steps=0, ih_last=math.inf, rose=False,
                         rises=0, J=J, j_fresh=True)

    def step(self, state: ADMMState):
        """One MM-ADMM step (``ADMMBase.admm``), with the chord Jacobian
        carried through its prox calls."""
        if not self.j_carry:
            new_state, info, _ = self.admm(state)
            return new_state._replace(j_fresh=False), info
        new_state, info, (J, _) = self.admm(state, (state.J, state.j_fresh))
        return new_state._replace(J=J, j_fresh=False), info

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

    def prox(self, z, dxpu, J_state=None):
        """The mesh's prox on every element: ``(z', ih0)``, or ``(z', ih0,
        J)`` with the carried chord Jacobian ``J_state = (J, fresh)``."""
        mesh = self.mesh
        args = (mesh.grid, z, mesh.xi, dxpu, self.free, self.prox_tol, self.prox_max_iters)
        return mesh.prox_fn(*args) if J_state is None else mesh.prox_fn(*args, J_state)

    def euler_grad(self, x):
        """The free-masked assembled gradient ``[NP, D]`` for the
        predictor (``Mesh::eulerGrad``)."""
        return self.mesh.gradient(x)[1]

    def energy(self, state: ADMMState) -> float:
        return float(self.mesh.energy(state.x))
