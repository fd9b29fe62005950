"""MM-ADMM on the stock element-major engine (port of
``mmadmm_tpu/integrators/admm.py::ADMMIntegrator``, on one device and
over ranks;
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

``ShardedADMMIntegrator`` runs the same step over the ranks of a
``parallel.RankGroup`` (``admm.py:388-640``): x is replicated, z, u and
the carried J hold the rank's shard of the partition-ordered elements
(``MovingMesh.shard``), padding masked by ``valid``, and the prox
(the same route: K1 or a K4 build on the rank's own shard, or the generic
prox) runs on the rank's elements only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..mesh import MovingMesh
from ..ops import huang
from ..ops.monitor_grid import gather_cell
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
        self.xi, self.ehat = mesh.xi, mesh.elem_ehat
        self.valid = torch.ones((mesh.n_elements, 1, 1), dtype=mesh.dtype, device=mesh.device)
        self.t_diag = self.tau + self.dt2w2 * mesh.deg  # [NP]

    def init_state(self) -> ADMMState:
        x0 = self.mesh.X0
        D = self.mesh.dim
        nf = self.free.shape[0]
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
        args = (mesh.grid, z, self.xi, dxpu, self.free, self.prox_tol, self.prox_max_iters)
        return mesh.prox_fn(*args) if J_state is None else mesh.prox_fn(*args, J_state)

    def euler_grad(self, x):
        """The free-masked assembled gradient ``[NP, D]`` for the
        predictor (``Mesh::eulerGrad``)."""
        return self.mesh.gradient(x)[1]

    def energy(self, state: ADMMState) -> float:
        return float(self.mesh.energy(state.x))

    def output_x(self, state: ADMMState, fname: str) -> str:
        """Debug dump of the node positions, one comma-separated point a
        line (``MeshIntegrator::outputX``, MeshIntegrator.cpp:219-232)."""
        np.savetxt(fname, state.x.detach().cpu().numpy(), delimiter=", ", fmt="%.17g")
        return fname

    def output_z(self, state: ADMMState, fname: str) -> str:
        """Debug dump of the element-stacked vertex vector ``z = D x``, one
        comma-separated row per element-vertex slot
        (``MeshIntegrator::outputZ``, MeshIntegrator.cpp:234-246; NF (D+1)
        rows, the reference's ``z->rows()/D``)."""
        z = self.mesh.gather(state.x).detach().cpu().numpy()
        np.savetxt(fname, z.reshape(-1, self.mesh.dim), delimiter=", ", fmt="%.17g")
        return fname


class ShardedADMMIntegrator(ADMMIntegrator):
    """MM-ADMM over the ranks of ``group``, each on its shard of the
    elements. ``halo=True`` (the JAX default) is the owner-computes step:
    each ``D^T`` all-reduces only the ``[C, D]`` partial sums of the nodes
    that two or more shards touch (``admm.py:451-468``; the rows private
    to other ranks stay incomplete here, and no element of this rank reads
    them), and x is rebuilt once a step from the ownership mask
    (``:587-592``). ``halo=False`` all-reduces the whole ``[NP, D]`` field
    each time; both give the same sums, node by node."""

    def __init__(self, mesh: MovingMesh, dt: float, group, *, halo: bool = True, **kw):
        super().__init__(mesh, dt, **kw)
        self.group = group
        self.halo = bool(halo)
        self.shard = sh = mesh.shard(group)
        self.free, self.valid, self.ehat, self.xi = sh.free, sh.valid, sh.ehat, sh.xi

    def gather(self, x):
        return self.shard.gather(x)

    def scatter(self, y):
        return self.shard.scatter(y, self.halo)

    def euler_grad(self, x):
        z = self.gather(x)
        _, g_e = huang.element_energy_grad(z, gather_cell(self.mesh.grid, z), self.ehat)
        return self.scatter(g_e * self.free)

    def reduce(self, t):
        return self.group.all_reduce_sum(t)

    def finish(self, x):
        return self.shard.owned(x) if self.halo else x

    SHARDED = ("u", "J")  # state fields that hold this rank's rows

    def gather_state(self, state: ADMMState) -> ADMMState:
        """The state with ``u`` and ``J`` of every element in natural
        element order (a collective: every rank calls it)."""
        return state._replace(**{f: self.shard.all_rows(getattr(state, f))
                                 for f in self.SHARDED})

    def scatter_state(self, state: ADMMState) -> ADMMState:
        """This rank's rows of a state that ``gather_state`` made."""
        return state._replace(**{f: self.shard.own_rows(getattr(state, f))
                                 for f in self.SHARDED})
