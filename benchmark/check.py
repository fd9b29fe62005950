"""The comparison that decides ``correct``: what the window kept, held to
the plain reference worked out from the configuration and the seeded
positions. The reference's steps are those of the module that the
traffic's ``reference`` key names (``reference/steps/<name>.py``).

* The first steps: the reference runs the method from the seeded start,
  step by step, and each of the steps the window kept from the start of
  a trajectory (``first_steps`` of them, or the whole trajectory where it
  is shorter) is compared with it.
* The sampled later step: the reference works it out from what the window
  kept before it, as far as the method's ``resume`` can (its docstring
  says how far).

The numbers, each with its limit from the traffic file:

* ``x_gap``: the largest ``|x - x_ref|`` over nodes and compared steps, in
  units of the smallest grid spacing;
* ``ih_gap``: the largest ``|I_h - I_h ref| / |I_h ref|`` over compared
  steps.
"""

from __future__ import annotations

import torch

from .inputs import spacing
from .reference.steps import load


def compare(cell, mesh, x0, window, *, dtype=torch.float64, device="cpu"):
    """``{name: value}`` of the numbers compared (see the module's
    docstring), the reference run in ``dtype`` on ``device``."""
    h = spacing(cell.cfg)
    method = load(cell.traffic["reference"])
    ref = method.build(cell.cfg, mesh, dtype=dtype, device=device)
    worst = {"x_gap": 0.0, "ih_gap": 0.0}

    def take(x, ih, got):
        if x is not None:
            gap = float((got.x.to(device=device, dtype=x.dtype) - x).abs().max()) / h
            worst["x_gap"] = max(worst["x_gap"], gap)
        worst["ih_gap"] = max(worst["ih_gap"], abs(got.ih - ih) / abs(ih))

    state = method.start(ref, x0.to(device=device, dtype=dtype))
    for got in window.first:
        state, x, ih = method.step(ref, state)
        take(x, ih, got)
    if window.sample is not None:
        take(*method.resume(ref, window.sample), window.sample.step)
    if not window.first:
        worst["x_gap"] = float("inf")  # nothing was kept: nothing is proven
    return worst
