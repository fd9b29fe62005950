"""Explicit Euler gradient flow on the 2D stencil engine (port of the
single-device structured-grid branch of
``mmadmm_tpu/integrators/euler.py``; reference methodType 1,
``MeshIntegrator::eulerStep``, ``MeshIntegrator.cpp:87-94``).

Each step is ``x <- x - (dt/tau) grad I(x)``, with the gradient assembled
to INTERIOR nodes only (``Mesh::eulerStepMod``, ``Mesh.cpp:533-579``) by
``ops/dense_eg2d.py`` on kernel K2. It reports the energy at the
pre-step positions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..mesh import MovingMesh
from ..ops.dense_eg2d import make_dense_eg2d


class EulerState(NamedTuple):
    """The state of both Euler integrators: positions, the positions
    before the last step, and the step count."""

    x: torch.Tensor  # [NP, 2]
    x_prev: torch.Tensor
    steps: int


class EulerInfo(NamedTuple):
    ih: float  # energy at the pre-step positions (f64 sum)


def dense_eg_or_raise(mesh: MovingMesh, nx: int, ny: int, method: str, item: str):
    """The stencil engine's evaluator for ``mesh`` (float32 or float64:
    kernels K2 and K3 are built in both), or ``NotImplementedError`` naming
    the ROADMAP item of the compact path a mesh off the gate would need."""
    eg = make_dense_eg2d(mesh, nx, ny)
    if eg is None:
        raise NotImplementedError(
            f"{method} off the stencil engine's gate runs on the compact path "
            f"(ROADMAP item {item})"
        )
    return eg


class EulerIntegrator:
    """Single-device explicit Euler on the stencil engine."""

    def __init__(self, mesh: MovingMesh, dt: float, nx: int, ny: int):
        self.mesh = mesh
        self.dt = float(dt)
        self.dt_tau = self.dt / mesh.tau
        self.eg = dense_eg_or_raise(mesh, nx, ny, "explicit Euler", "A11")

    def init_state(self) -> EulerState:
        x0 = self.mesh.X0
        return EulerState(x=x0, x_prev=x0, steps=0)

    def step(self, state: EulerState):
        ih, g = self.eg(state.x)
        x = state.x - self.dt_tau * g
        return (EulerState(x=x, x_prev=state.x, steps=state.steps + 1),
                EulerInfo(ih=float(ih)))
