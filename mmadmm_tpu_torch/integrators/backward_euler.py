"""Backward Euler on the 2D stencil engine (port of the single-device
kernel branch of ``mmadmm_tpu/integrators/backward_euler.py``, default
``neumann`` solver; reference methodType 2, ``Mesh::backwardsEulerStep``,
``Mesh.cpp:1264-1341``).

Each step solves ``F(x) = (dt/tau) grad I(x) + (x - x^n) = 0``
(``Mesh.cpp:1289-1293``) by Newton:

* initial guess: one explicit Euler step (``Mesh.cpp:1271-1273``), on
  kernel K2 (``ops/dense_eg2d.py``);
* chord Jacobian, built once per step at the guess: the element Hessians
  ``He [21, NFd]`` from kernel K3 (``ops/be2d.py::hess2d``) and the
  Jacobi diagonal ``dvec = 1 + (dt/tau) interior * D^T diag(He)``;
* matvec ``J v = v + (dt/tau) interior * D^T (He D v)``, with ``D`` and
  ``D^T`` as stencil window slices and pad-adds;
* each Newton iteration: 6 Jacobi-preconditioned Richardson terms for
  ``J dx = -F``, the residual-norm safeguard (else the plain Jacobi step),
  the finiteness fallback ``dx = -F``, and the best-seen iterate;
* stop when ``||F||_1 < 0.1 tol`` (``Mesh.cpp:1268,1298``), after 1000
  iterations (``Mesh.cpp:1275``), or when ``||F||_1`` stops decreasing
  (the f32 noise floor).

A step reports the energy at the post-step positions (``Mesh.cpp:1340``)
and its Newton count. The safeguard, the fallback and the best-seen
choice stay on the device as ``torch.where`` on 0-d tensors; the stop test
reads ``||F||_1`` on the host once per Newton iteration, the port's
counterpart of the JAX package's ``lax.while_loop``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..mesh import MovingMesh
from ..ops.be2d import hess2d
from ..ops.reductions import sum_f64
from .euler import EulerState, dense_eg_or_raise

_MAX_NEWTON = 1000  # Mesh.cpp:1275
_SAFETY = 0.1  # SAFETY_FAC, Mesh.cpp:1268
_TERMS = 6  # Richardson terms per Newton iteration (the JAX neumann default)
_PROGRESS = 0.9999  # stall stop: ||F|| must fall by this factor


def _tri(i: int, j: int) -> int:
    """Channel of ``H[i][j]`` in the lower-triangle layout."""
    i, j = max(i, j), min(i, j)
    return i * (i + 1) // 2 + j


class BEInfo(NamedTuple):
    ih: float  # energy at the post-step positions (f64 sum)
    n_newton: int


class BackwardEulerIntegrator:
    """Single-device backward Euler on the stencil engine, chord Newton
    with the Jacobi-Richardson (``neumann``) inner solve."""

    def __init__(self, mesh: MovingMesh, dt: float, nx: int, ny: int, *,
                 tol: float = 1e-3, krylov_solver: str = "neumann",
                 precondition: bool = False, chord_carry: bool = False):
        if krylov_solver != "neumann":
            raise NotImplementedError(
                f"the {krylov_solver!r} inner solver and ops/krylov.py are ROADMAP "
                "item A12; the port has the neumann solver"
            )
        if precondition:
            raise NotImplementedError("precondition=True is ROADMAP item A12")
        if chord_carry:
            raise NotImplementedError("the cross-step chord carry is ROADMAP item A12")
        self.mesh = mesh
        self.dt = float(dt)
        self.dt_tau = self.dt / mesh.tau
        self.tol = float(tol)
        self.eg = dense_eg_or_raise(mesh, nx, ny, "backward Euler", "A12")

    def init_state(self) -> EulerState:
        x0 = self.mesh.X0
        return EulerState(x=x0, x_prev=x0, steps=0)

    def residual(self, x, xn):
        """``F(x) = (dt/tau) grad I(x) + (x - x^n)``."""
        return self.dt_tau * self.eg(x)[1] + (x - xn)

    def build_chord(self, x):
        """``(He [21, NFd], dvec [NP, 2])`` at positions ``x`` (K3)."""
        eg = self.eg
        z = eg.gather(x)
        He = hess2d(z, eg.cells(z), self.mesh.ehat_np.reshape(-1))
        diag = torch.stack([He[_tri(i, i)] for i in range(6)])
        dvec = 1.0 + self.dt_tau * (eg.scatter(diag) * self.mesh.interior_nodes)
        return He, dvec

    def matvec(self, He):
        """``v -> J v`` for the chord ``He``."""
        eg, interior, dt_tau = self.eg, self.mesh.interior_nodes, self.dt_tau

        def mv(v):
            vz = eg.gather(v)
            hv = []
            for i in range(6):
                acc = He[_tri(i, 0)] * vz[0]
                for j in range(1, 6):
                    acc = acc + He[_tri(i, j)] * vz[j]
                hv.append(acc)
            return v + dt_tau * (eg.scatter(torch.stack(hv)) * interior)

        return mv

    def newton(self, x, xn, mv, dvec):
        """Chord Newton from ``x``: ``(x', iterations)``."""
        F = self.residual(x, xn)
        gnorm = sum_f64(F.abs())
        g_now, g_prev = float(gnorm), math.inf
        it = 0
        while (it < _MAX_NEWTON and g_now >= _SAFETY * self.tol
               and g_now < g_prev * _PROGRESS):
            b = -F
            dx = b / dvec
            for _ in range(_TERMS):
                dx = dx + (b - mv(dx)) / dvec
            # safeguard: a diverged inner solve falls back to the Jacobi step
            rnorm = sum_f64((b - mv(dx)).abs())
            dx = torch.where(rnorm <= sum_f64(b.abs()), dx, b / dvec)
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

    def step(self, state: EulerState):
        xn = state.x
        x_guess = xn - self.dt_tau * self.eg(xn)[1]
        He, dvec = self.build_chord(x_guess)
        x, n_newton = self.newton(x_guess, xn, self.matvec(He), dvec)
        ih = float(self.eg(x)[0])
        return (EulerState(x=x, x_prev=xn, steps=state.steps + 1),
                BEInfo(ih=ih, n_newton=n_newton))
