"""The float64 3D stencil engine end to end: the port's SoAADMM3D in
float64 (kernel K4 built in float64; its plain version on the CPU).

* 3D SquareGrid nx=4 (the radial bump, the 48-wide cell table) against
  the JAX package's float64 SoAADMM3D in stencil mode (``MMADMM_SOA=1``,
  its Pallas kernel built in float64, in interpreter mode), both started
  from the same state through ``convert``, over 4 steps (the helpers of
  tests/_torch_soa3d.py: one module-scoped interpreted compile, some three
  minutes on a CPU, under its lock). Bands: the same ADMM iteration count
  at every step, ``I_h`` within rel 1e-10 and the final node positions
  within atol 1e-10 (measured on an Intel Xeon CPU: 2.2e-16 and 6.7e-16).
* 3D Shoulder nx=4 (the identity monitor; the carve and its fixed nodes)
  against the JAX package's own float64 route for it, the stock engine
  with the generic prox and the carried chord Jacobian (its stencil
  engine would need a second interpreted compile; K4's module test,
  tests/test_torch_f64_prox3d.py, holds the kernel to JAX's on Shoulder's
  slots). The two prox solvers (Newton sweeps against the chord Jacobian)
  stop within the same tolerance at different iterates, so the band is
  theirs: the same ADMM iteration counts, ``I_h`` within rel 1e-7 and the
  final node positions within atol 5e-7 (measured: 5.0e-9 and 1.8e-8)."""

import math

import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.problems import build_problem as jax_build_problem

import _torch_soa3d as S
from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem
from mmadmm_tpu_torch.integrators.admm_soa import SoAADMM3D

KW = S.config("SquareGrid", 1, "float64")
KW_SHOULDER = S.config("Shoulder", 0, "float64")


@pytest.fixture(scope="module")
def jax_run():
    j = S.run_jax(KW)
    assert j["x0"].dtype == j["x"].dtype == np.float64
    return j


@pytest.fixture(scope="module")
def port_run(jax_run):
    integ, state = S.port_from_jax(KW, jax_run)
    assert state.x.dtype == state.u.dtype == integ.free.dtype == torch.float64
    infos, state = S.run_port(integ, state)
    return integ, infos, state


@pytest.mark.parametrize("k", range(S.STEPS))
def test_soa3d_step_matches_jax_in_float64(jax_run, port_run, k):
    S.check_step(jax_run["infos"], port_run[1], k, rel=1e-10)


def test_soa3d_final_state_matches_jax_in_float64(jax_run, port_run):
    S.check_final_state(jax_run, port_run[2], atol=1e-10)
    assert port_run[2].x.dtype == torch.float64


def test_soa3d_energy_falls_in_float64(port_run):
    S.check_energy_falls(*port_run)


def test_soa3d_float64_round_trip_and_own_constants(jax_run):
    S.check_round_trip(KW, jax_run)


@pytest.fixture(scope="module")
def shoulder_runs():
    """The JAX package's float64 stock route and the port's float64 3D
    stencil engine, each from its own initial state, over S.STEPS steps:
    ``(JAX [(ih, n_iters)], JAX final x [NP, 3], port infos, port final
    state)``."""
    jmesh, jinteg = jax_build_problem(JaxConfig(**KW_SHOULDER))
    assert type(jinteg).__name__ == "ADMMIntegrator" and jmesh.prox_backend == "vmap"
    s, jax_infos = jinteg.init_state(), []
    for _ in range(S.STEPS):
        s, info = jinteg.step(s)
        jax_infos.append((float(info.ih_start), int(info.n_iters)))
    _, integ = build_problem(ExperimentConfig(**KW_SHOULDER), device="cpu")
    assert isinstance(integ, SoAADMM3D)
    np.testing.assert_array_equal(integ.x0.numpy().T, np.asarray(jmesh.X0))
    infos, state = S.run_port(integ, integ.init_state())
    return jax_infos, np.asarray(s.x), infos, state


@pytest.mark.parametrize("k", range(S.STEPS))
def test_shoulder_step_matches_the_jax_float64_route(shoulder_runs, k):
    S.check_step(shoulder_runs[0], shoulder_runs[2], k, rel=1e-7)


def test_shoulder_final_state_matches_the_jax_float64_route(shoulder_runs):
    _, x_j, infos, state = shoulder_runs
    assert state.x.dtype == torch.float64
    np.testing.assert_allclose(state.x.numpy().T, x_j, rtol=0, atol=5e-7)
    ih = [i.ih for i in infos]
    assert all(math.isfinite(v) for v in ih) and ih[-1] < ih[0]
