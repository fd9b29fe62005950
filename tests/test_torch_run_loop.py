"""The port's outer loop (``integrators/run_loop.py::run``) against the JAX
package's (``integrators/device_loop.py::build_run_loop``) on scripted
energy traces: the same steps taken and the same trace for the DtTol, the
target (armed at ``min_steps``), the rise and the non-finite stops
(``tests/test_device_loop.py:48``, ``:88``). A fake integrator replays
the script, so no mesh is built; the JAX loop is compiled once per cap.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmadmm_tpu.integrators.device_loop import build_run_loop

from mmadmm_tpu_torch.integrators.run_loop import run

DT = 5e-3
CAP = 16
# a falling trace with a plateau (DtTol), a rise at step 6 and a second
# downward crossing of 0.9 after it
FALL_RISE = [1.0, 0.95, 0.9, 0.88, 0.87, 0.86, 0.93, 0.91, 0.89, 0.85, 0.84, 0.84, 0.84,
             0.83, 0.82, 0.81]
SCRIPTS = {
    "fall_rise": FALL_RISE,
    "plateau": [2.0, 1.5, 1.2, 1.1, 1.1 - 1e-9, 1.05] + [1.0] * 10,
    "nan": [1.0, 0.9, 0.8, math.nan, 0.7] + [0.6] * 11,
}
CASES = {
    "dttol": ("plateau", dict(dt_tol=1e-5)),
    "no_stop": ("fall_rise", dict(dt_tol=0.0)),
    "target": ("fall_rise", dict(dt_tol=0.0, target_ih=0.9)),
    "target_min_steps": ("fall_rise", dict(dt_tol=0.0, target_ih=0.9, min_steps=7)),
    "target_armed_late": ("fall_rise", dict(dt_tol=0.0, target_ih=0.9, min_steps=12)),
    "rise": ("fall_rise", dict(dt_tol=0.0, stop_on_rise=True)),
    "rise_and_target": ("fall_rise", dict(dt_tol=0.0, target_ih=0.85, stop_on_rise=True)),
    "nan": ("nan", dict(dt_tol=0.0)),
}


class Info(NamedTuple):
    ih: float


class Scripted:
    """An integrator whose k-th step reports ``script[k]``."""

    dt = DT

    def __init__(self, script):
        self.script = script

    def init_state(self):
        return 0

    def step(self, k):
        return k + 1, Info(ih=self.script[k])


@pytest.fixture(scope="module")
def jax_loop():
    def step_fn(k, script):
        return k + 1, script[k]

    return jax.jit(build_run_loop(step_fn, DT, CAP))


def run_jax(jax_loop, script, dt_tol, target_ih=None, min_steps=0, stop_on_rise=False):
    use = target_ih is not None
    k, trace, steps = jax_loop(
        jnp.zeros((), jnp.int32), jnp.asarray(script, jnp.float64),
        jnp.asarray(dt_tol, jnp.float64), jnp.asarray(target_ih if use else 0.0, jnp.float64),
        jnp.asarray(use), jnp.asarray(min_steps, jnp.int32), jnp.asarray(stop_on_rise))
    return int(k), np.asarray(trace), int(steps)


@pytest.mark.parametrize("case", list(CASES))
def test_stops_as_the_jax_loop(jax_loop, case):
    name, kw = CASES[case]
    script = SCRIPTS[name]
    k_j, trace_j, steps_j = run_jax(jax_loop, script, **kw)
    k_p, trace_p, steps_p = run(Scripted(script), 0, cap=CAP, **kw)
    assert steps_p == steps_j == k_p == k_j
    np.testing.assert_array_equal(trace_p, trace_j)


def test_the_stops_land_where_the_script_says(jax_loop):
    """The cases cover each stop: DtTol at the plateau's second step, the
    first touch of the target, the target armed at ``min_steps`` (at
    once if the energy is still below it, else at the next crossing), the
    first rise, the first non-finite energy, and no stop at all."""
    expected = {"dttol": 5, "no_stop": CAP, "target": 3, "target_min_steps": 9,
                "target_armed_late": 12, "rise": 7, "rise_and_target": 7, "nan": 4}
    for case, steps in expected.items():
        name, kw = CASES[case]
        assert run(Scripted(SCRIPTS[name]), 0, cap=CAP, **kw)[2] == steps, case


def test_defaults_keep_the_old_stops():
    """Without ``min_steps`` and ``stop_on_rise`` the loop stops as before
    they existed: a rise does not stop it, the target stops at its first
    touch."""
    script = FALL_RISE
    assert run(Scripted(script), 0, cap=CAP, dt_tol=0.0)[2] == CAP
    assert run(Scripted(script), 0, cap=CAP, dt_tol=0.0, target_ih=0.9)[2] == 3
