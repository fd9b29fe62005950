"""MM-ADMM (method 0), as the port states the reference step
(``MeshIntegrator::step``, ``MeshIntegrator.cpp:101-191``): the
energy-guarded predictor, then at most ``AdmmIter`` iterations of prox
z-update, scaled dual update and the diagonal x-update, stopping when the
primal and dual residuals (float64 sums) are both under the ADMM
tolerance. The I_h a step reports is the prox's energy at its first
iteration.

A kept later step is worked out only through its predictor: the step's
scaled dual, which the rest of the step needs, is carried from step to
step in the program's own layout, which the reference does not read. So
``resume`` gives the I_h of the predictor's x-bar, and the reference
follows the steps from the seeded start for the rest."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..problem import ADMM_TOL, Problem

build = Problem


class State(NamedTuple):
    x: torch.Tensor  # [NP, 3]
    x_prev: torch.Tensor
    u: torch.Tensor  # [NF, 4, 3] scaled dual
    steps: int
    ih_last: float
    rose: bool
    rises: int


def start(ref: Problem, x0) -> State:
    u = torch.zeros((ref.n_elements, 4, 3), dtype=ref.dtype, device=ref.device)
    return State(x=x0, x_prev=x0, u=u, steps=0, ih_last=math.inf, rose=False, rises=0)


def predict(ref: Problem, x, x_prev, steps: int, rose: bool, rises: int):
    """The energy-guarded predictor: explicit Euler in the first three
    steps and after one rise, x held after two rises in a row, else linear
    extrapolation."""
    if ref.grad_use or steps <= 2 or (rose and rises < 2):
        return x - (ref.dt / ref.tau) * ref.element_grad(x, mask_free=True)[1]
    if rose:
        return x
    return 2.0 * x - x_prev


def x_update(ref: Problem, x_bar, z, u):
    return (ref.tau * x_bar + ref.dt2w2 * ref.scatter(z - u)) / ref.t_node


def step(ref: Problem, s: State):
    x_bar = predict(ref, s.x, s.x_prev, s.steps, s.rose, s.rises)
    z = ref.gather(s.x if s.steps == 0 else x_bar)
    u = torch.zeros_like(s.u) if s.steps == 0 else s.u
    x = x_update(ref, x_bar, z, u)
    gx = ref.gather(x)
    ih = 0.0
    for i in range(ref.admm_iters):
        dxpu = gx + u
        z_prev = z
        z, ih0 = ref.prox(z, dxpu)
        if i == 0:
            ih = float(ih0)
        u = dxpu - z
        x = x_update(ref, x_bar, z, u)
        gx = ref.gather(x)
        primal = math.sqrt(float(((gx - z) ** 2).sum(dtype=torch.float64)))
        dual = math.sqrt(float(((z - z_prev) ** 2).sum(dtype=torch.float64)))
        if primal < ADMM_TOL and dual < ADMM_TOL:
            break
    rose = ih > s.ih_last
    return (State(x=x, x_prev=s.x, u=u, steps=s.steps + 1, ih_last=ih, rose=rose,
                  rises=s.rises + 1 if rose else 0), x, ih)


def resume(ref: Problem, sample):
    """The I_h that the kept step ``sample.index`` reports: the energy of
    the predictor's x-bar from the positions after the two steps before it
    and the I_h of every step before it."""
    rises, last, rose = 0, math.inf, False
    for ih in sample.ihs:
        rose = ih > last
        rises = rises + 1 if rose else 0
        last = ih
    x, x_prev = (t.to(device=ref.device, dtype=ref.dtype) for t in (sample.before,
                                                                   sample.before2))
    return None, ref.energy(predict(ref, x, x_prev, len(sample.ihs), rose, rises))
