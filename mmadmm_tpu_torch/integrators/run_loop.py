"""The outer time loop with the reference's stops (port of
``mmadmm_tpu/integrators/device_loop.py::build_run_loop``; reference
``main.cpp:180-211``).

The JAX package folds this loop into one device program; here it runs on
the host, since every step already reads its energy there. Stops: the
first step never stops; then ``|Ih - Ih_prev| / dt < dt_tol`` (DtTol),
the optional first touch of ``target_ih`` (armed from step ``min_steps``
on), the optional first rise (``stop_on_rise``), a non-finite energy, or
the step cap.
"""

from __future__ import annotations

import math

import numpy as np


def run(integ, state, *, cap: int, dt_tol: float, target_ih: float | None = None,
        min_steps: int = 0, stop_on_rise: bool = False, on_step=None):
    """Step ``integ`` from ``state`` until a stop. ``integ.step(state)``
    returns ``(state, info)`` with the step's energy in ``info.ih`` (for
    MM-ADMM and explicit Euler at the step's start, for backward Euler at
    its end, as in the JAX package). Returns ``(state, trace [cap]
    float64, steps)``; trace slots after the last step are NaN.

    ``min_steps`` arms the target stop only once ``min_steps`` steps are
    taken: under the predictor guard the trace is not monotone, so time to
    a target energy means its last downward crossing, which the caller
    finds from a full run's trace. ``stop_on_rise`` ends the run at the
    first energy above the step before it (after the first step): the
    commented-out ``|| dIdt > 0`` clause of the reference's stop
    (``main.cpp:204``), which some recorded artifacts evidently used.
    ``on_step(k, info)``, if given, runs after each step."""
    cap = int(cap)
    trace = np.full(cap, np.nan)
    ih_prev = math.inf
    k = 0
    while k < cap:
        state, info = integ.step(state)
        ih = float(info.ih)
        trace[k] = ih
        if on_step is not None:
            on_step(k, info)
        stop = (
            (k > 0 and abs((ih - ih_prev) / integ.dt) < dt_tol)
            or (target_ih is not None and k + 1 >= min_steps and ih <= target_ih)
            or (stop_on_rise and k > 0 and ih > ih_prev)
            or not math.isfinite(ih)
        )
        ih_prev = ih
        k += 1
        if stop:
            break
    return state, trace, k
