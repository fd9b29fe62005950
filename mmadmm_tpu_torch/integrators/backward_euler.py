"""Backward Euler by chord Newton (port of the single-device branches of
``mmadmm_tpu/integrators/backward_euler.py``; reference methodType 2,
``Mesh::backwardsEulerStep``, ``Mesh.cpp:1264-1341``).

Each step solves ``F(x) = (dt/tau) grad I(x) + (x - x^n) = 0``
(``Mesh.cpp:1289-1293``) by Newton:

* initial guess: one explicit Euler step (``Mesh.cpp:1271-1273``);
* chord Jacobian, built at the guess: the element Hessians ``He`` and
  the Jacobi diagonal ``dvec = 1 + (dt/tau) interior * D^T diag(He)``;
* matvec ``J v = v + (dt/tau) interior * D^T (He D v)``;
* each Newton iteration solves ``J dx = -F`` with the inner solver
  ``krylov_solver``, falls back to ``dx = -F`` where the step is not
  finite, and keeps the best iterate seen;
* stop when ``||F||_1 < 0.1 tol`` (``Mesh.cpp:1268,1298``), after
  ``max_newton`` iterations (1000, ``Mesh.cpp:1275``), or when ``||F||_1``
  stops decreasing (the float32 noise floor).

A step reports the energy at the post-step positions (``Mesh.cpp:1340``)
and its Newton count. The gradient, ``He`` and the matvec come from one of
two evaluators (``euler.evaluator``): the 2D stencil engine (K2 and K3,
``He`` the lower triangle ``[21, NFd]``, ``ops/dense_eg2d.py``) for a 2D box
on the stencil gate with the ``neumann`` solver, else the compact
element-major path (``He [NF, n, n]``, ``ops/compact_eg.py``), as the JAX
package routes them (``backward_euler.py:183-190``: every other solver
takes the compact path).

The options, with the JAX package's defaults (its environment variables
become arguments):

* ``krylov_solver`` (``MMADMM_BE_KRYLOV``): ``neumann``, 6
  Jacobi-preconditioned Richardson terms on the chord and the
  residual-norm safeguard (else the plain Jacobi step); ``hess``,
  ``ops/krylov.py::bicgstab`` (8 trips) on the explicit Hessians rebuilt
  at each Newton iterate; ``cgstab`` and ``cg``, ``bicgstab`` and ``cg``
  (40 trips) on a ``torch.func.jvp`` of the assembled residual;
  ``scipy``, ``krylov.scipy_bicgstab`` (the algorithm of
  ``jax.scipy.sparse.linalg.bicgstab``) on the same jvp;
* ``krylov_tol`` (1e-6) and ``krylov_maxiter`` (``MMADMM_BE_TERMS``: the
  trip counts above);
* ``precondition``: the Jacobi preconditioner ``v / dj``, ``dj = 1 +
  (dt/tau) interior * D^T diag(Hess e)`` of the element energies at the
  guess, ``|dj| < 1e-8 -> 1`` (``jac_diag``, ``:382-402``), for the Krylov
  solvers; ``neumann`` has its own diagonal and does not read it;
* ``chord_carry`` (``MMADMM_BE_CHORD=1``, ``neumann`` only) with
  ``rebuild_at`` (``MMADMM_BE_REBUILD``, 5): ``He`` and ``dvec`` ride the
  state and are rebuilt only at the first step and after a step of
  ``rebuild_at`` or more Newton iterations (``:152-173``, ``:616-630``).

Over the ranks of a ``parallel.RankGroup`` (``group``) the step runs on
``compact_eg.ShardedEG`` (``backward_euler.py:654-860``): one all-reduce a
gradient and a matvec, x and the Krylov vectors replicated, so every rank
computes the same norms and dots and stops at the same iteration. As in
the JAX package (``:665-668``), only ``hess`` and ``neumann`` run sharded,
without ``precondition`` or ``chord_carry``.

The safeguard, the fallback and the best-seen choice stay on the device
as ``torch.where`` on 0-d tensors; the stop test reads ``||F||_1`` on the
host once per Newton iteration, the port's counterpart of the JAX
package's ``lax.while_loop``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..mesh import MovingMesh
from ..ops import krylov
from ..ops.reductions import sum_f64
from .euler import evaluator

_SAFETY = 0.1  # SAFETY_FAC, Mesh.cpp:1268
_PROGRESS = 0.9999  # stall stop: ||F|| must fall by this factor
SOLVERS = ("neumann", "hess", "cgstab", "cg", "scipy")
_MAXITER = {"neumann": 6, "hess": 8}  # else 40 (backward_euler.py:133-138)


class BackwardEulerState(NamedTuple):
    x: torch.Tensor  # [NP, D]
    x_prev: torch.Tensor
    steps: int
    # the carried chord (chord_carry only, else None): He and dvec, and
    # whether the last step's Newton count asks for a rebuild
    He: torch.Tensor | None = None
    dvec: torch.Tensor | None = None
    rebuild: bool = False


class BEInfo(NamedTuple):
    ih: float  # energy at the post-step positions (f64 sum)
    n_newton: int


class BackwardEulerIntegrator:
    """Backward Euler, on one device or over the ranks of ``group``."""

    def __init__(self, mesh: MovingMesh, dt: float, *,
                 grid2d_dims: tuple[int, int] | None = None, tol: float = 1e-3,
                 max_newton: int = 1000, krylov_tol: float = 1e-6,
                 krylov_maxiter: int | None = None, krylov_solver: str = "neumann",
                 precondition: bool = False, chord_carry: bool = False, rebuild_at: int = 5,
                 group=None):
        if krylov_solver not in SOLVERS:
            raise ValueError(f"unknown krylov_solver {krylov_solver!r}")
        if group is not None and (krylov_solver not in ("hess", "neumann") or precondition
                                  or chord_carry):
            raise ValueError("sharded backward Euler runs the hess and neumann solvers only, "
                             "without precondition or chord_carry")
        self.mesh = mesh
        self.dt = float(dt)
        self.dt_tau = self.dt / mesh.tau
        self.tol = float(tol)
        self.max_newton = int(max_newton)
        self.krylov_solver = krylov_solver
        self.krylov_tol = float(krylov_tol)
        self.krylov_maxiter = int(krylov_maxiter if krylov_maxiter is not None
                                  else _MAXITER.get(krylov_solver, 40))
        self.precondition = bool(precondition)
        self.chord_carry = bool(chord_carry) and krylov_solver == "neumann"
        self.rebuild_at = int(rebuild_at)
        self.eg = evaluator(mesh, grid2d_dims if krylov_solver == "neumann" else None, group)

    def init_state(self) -> BackwardEulerState:
        x0 = self.mesh.X0
        return BackwardEulerState(x=x0, x_prev=x0, steps=0)

    def residual(self, x, xn):
        """``F(x) = (dt/tau) grad I(x) + (x - x^n)``."""
        return self.dt_tau * self.eg(x)[1] + (x - xn)

    def build_chord(self, x):
        """``(He, dvec [NP, D])`` at positions ``x``."""
        He = self.eg.hessians(x)
        return He, 1.0 + self.dt_tau * (self.eg.hdiag(He) * self.mesh.interior_nodes)

    def matvec(self, He):
        """``v -> J v`` for the element Hessians ``He``."""
        eg, interior, dt_tau = self.eg, self.mesh.interior_nodes, self.dt_tau

        def mv(v):
            return v + dt_tau * (eg.apply(He, v) * interior)

        return mv

    def jac_diag(self, x):
        """The Jacobi preconditioner's diagonal at ``x``."""
        dj = 1.0 + self.dt_tau * (self.eg.energy_hdiag(x) * self.mesh.interior_nodes)
        return torch.where(dj.abs() < 1e-8, 1.0, dj)

    def solver(self, xn, He, dvec, dj):
        """``solve(x, F) -> dx``, the inner solve of ``J(x) dx = -F``."""
        kind, tol, maxiter = self.krylov_solver, self.krylov_tol, self.krylov_maxiter
        M = None if dj is None else (lambda v: v / dj)
        if kind == "neumann":
            mv = self.matvec(He)

            def solve(x, F):
                b = -F
                dx = b / dvec
                for _ in range(maxiter):
                    dx = dx + (b - mv(dx)) / dvec
                # safeguard: a diverged inner solve falls back to the Jacobi step
                rnorm = sum_f64((b - mv(dx)).abs())
                return torch.where(rnorm <= sum_f64(b.abs()), dx, b / dvec)
        elif kind == "hess":
            def solve(x, F):
                mv = self.matvec(self.eg.hessians(x))
                return krylov.bicgstab(mv, -F, tol=tol, maxiter=maxiter, M=M)[0]
        else:
            def solve(x, F):
                def jvp(v):
                    return torch.func.jvp(lambda y: self.residual(y, xn), (x,), (v,))[1]

                if kind == "scipy":
                    return krylov.scipy_bicgstab(jvp, -F, tol=tol, maxiter=maxiter, M=M)
                fn = krylov.bicgstab if kind == "cgstab" else krylov.cg
                return fn(jvp, -F, tol=tol, maxiter=maxiter, M=M)[0]
        return solve

    def newton(self, x, xn, solve):
        """Newton from ``x`` with the inner solve ``solve``: ``(x',
        iterations)``."""
        F = self.residual(x, xn)
        gnorm = sum_f64(F.abs())
        g_now, g_prev = float(gnorm), math.inf
        it = 0
        while (it < self.max_newton and g_now >= _SAFETY * self.tol
               and g_now < g_prev * _PROGRESS):
            dx = solve(x, F)
            dx = torch.where(torch.isfinite(dx).all(), dx, -F)
            x_new = x + dx
            F_new = self.residual(x_new, xn)
            g_new = sum_f64(F_new.abs())
            # keep the best iterate seen; a rise leaves x, F and ||F|| as
            # they were, and the stall stop then ends the loop
            better = g_new < gnorm
            x = torch.where(better, x_new, x)
            F = torch.where(better, F_new, F)
            gnorm = torch.where(better, g_new, gnorm)
            g_prev, g_now = g_now, float(gnorm)
            it += 1
        return x, it

    def step(self, state: BackwardEulerState):
        xn = state.x
        x_guess = xn - self.dt_tau * self.eg(xn)[1]
        He = dvec = dj = None
        if self.chord_carry and state.steps > 0 and not state.rebuild:
            He, dvec = state.He, state.dvec
        elif self.krylov_solver == "neumann":
            He, dvec = self.build_chord(x_guess)
        elif self.precondition:
            dj = self.jac_diag(x_guess)
        x, n_newton = self.newton(x_guess, xn, self.solver(xn, He, dvec, dj))
        ih = float(self.eg.energy(x))
        carried = (He, dvec) if self.chord_carry else (state.He, state.dvec)
        new = BackwardEulerState(x=x, x_prev=xn, steps=state.steps + 1, He=carried[0],
                                 dvec=carried[1], rebuild=n_newton >= self.rebuild_at)
        return new, BEInfo(ih=ih, n_newton=n_newton)
