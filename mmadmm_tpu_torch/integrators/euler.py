"""Explicit Euler gradient flow (port of the single-device branches of
``mmadmm_tpu/integrators/euler.py``; reference methodType 1,
``MeshIntegrator::eulerStep``, ``MeshIntegrator.cpp:87-94``).

Each step is ``x <- x - (dt/tau) grad I(x)``, with the gradient assembled
to INTERIOR nodes only (``Mesh::eulerStepMod``, ``Mesh.cpp:533-579``). It
reports the energy at the pre-step positions. The gradient comes from one
of two evaluators (``evaluator``):

* the 2D stencil engine (``ops/dense_eg2d.py``, kernel K2) for a 2D box
  mesh on the stencil gate, when the caller passes its grid dims
  ``grid2d_dims = (nx, ny)`` (``problems.py`` does for SquareGrid and
  Shoulder meshes that are not computational meshes);
* the compact element-major path (``ops/compact_eg.py``, plain PyTorch)
  for every other mesh: 3D meshes, computational meshes, FromFile and
  LevelSet meshes, 2D boxes off the gate.

The JAX package takes its stencil engine only from 50,000 elements
(``euler.py:86-92``); the port takes it wherever the gate holds, and
``tests/test_torch_euler_compact.py`` holds the two routes to each other.

Over the ranks of a ``parallel.RankGroup`` (``group``) the step runs on
``compact_eg.ShardedEG``: each rank's elements, one all-reduce a gradient
(``build_sharded_gradient`` and the sharded step, ``euler.py:32-62,
125-175``), never the stencil engine.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..mesh import MovingMesh
from ..ops.compact_eg import CompactEG, ShardedEG
from ..ops.dense_eg2d import make_dense_eg2d


class EulerState(NamedTuple):
    """The explicit-Euler state: positions, the positions before the last
    step, and the step count."""

    x: torch.Tensor  # [NP, D]
    x_prev: torch.Tensor
    steps: int


class EulerInfo(NamedTuple):
    ih: float  # energy at the pre-step positions (f64 sum)


def evaluator(mesh: MovingMesh, grid2d_dims: tuple[int, int] | None, group=None):
    """The sharded evaluator over ``group``'s ranks; else the stencil
    engine's evaluator for a 2D mesh on the (nx, ny) grid's gate (float32
    or float64: kernels K2 and K3 are built in both), else the compact one.
    A computational mesh, or a grid without the symmetric 16-wide table,
    always takes the compact one: K2 and K3 know only the constant
    reference Ehat and that table."""
    if group is not None:
        return ShardedEG(mesh, group)
    if grid2d_dims is not None and mesh.dim == 2 and not mesh.comp_mesh and mesh.grid.kernel_table:
        eg = make_dense_eg2d(mesh, *grid2d_dims)
        if eg is not None:
            return eg
    return CompactEG(mesh)


class EulerIntegrator:
    """Explicit Euler, on one device or over the ranks of ``group``."""

    def __init__(self, mesh: MovingMesh, dt: float, *,
                 grid2d_dims: tuple[int, int] | None = None, group=None):
        self.mesh = mesh
        self.dt = float(dt)
        self.dt_tau = self.dt / mesh.tau
        self.eg = evaluator(mesh, grid2d_dims, group)

    def init_state(self) -> EulerState:
        x0 = self.mesh.X0
        return EulerState(x=x0, x_prev=x0, steps=0)

    def step(self, state: EulerState):
        ih, g = self.eg(state.x)
        x = state.x - self.dt_tau * g
        return (EulerState(x=x, x_prev=state.x, steps=state.steps + 1),
                EulerInfo(ih=float(ih)))
