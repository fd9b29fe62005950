"""Explicit Euler (method 1): ``x <- x - (dt/tau) grad I(x)``, the gradient
assembled to INTERIOR nodes (``Mesh::eulerStepMod``); the I_h it reports
is the pre-step energy. Its state is its positions, so a kept step is
worked out whole from the positions before it."""

from __future__ import annotations

from ..problem import Problem

build = Problem


def start(ref: Problem, x0):
    return x0


def step(ref: Problem, x):
    ih, g = ref.element_grad(x, mask_free=False)
    x = x - (ref.dt / ref.tau) * (g * ref.interior)
    return x, x, float(ih)


def resume(ref: Problem, sample):
    _, x, ih = step(ref, sample.before.to(device=ref.device, dtype=ref.dtype))
    return x, ih
