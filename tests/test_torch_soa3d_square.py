"""The 3D slice end to end at 3D SquareGrid nx=4 with the radial-bump monitor: 768 tets, none carved,
on the 48-wide symmetric cell table: the port's SoAADMM3D against the
JAX package's (tests/_torch_soa3d.py says how, and with which bands)."""

import pytest
import torch

import _torch_soa3d as S
from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem
from mmadmm_tpu_torch.integrators.run_loop import run

KW = S.config("SquareGrid", 1)


@pytest.fixture(scope="module")
def jax_run():
    return S.run_jax(KW)


@pytest.fixture(scope="module")
def port_run(jax_run):
    integ, state = S.port_from_jax(KW, jax_run)
    infos, state = S.run_port(integ, state)
    return integ, infos, state


@pytest.fixture(scope="module")
def port_alone():
    """The port on its own set-up, without the JAX package's constants."""
    _, integ = build_problem(ExperimentConfig(**KW), device="cpu")
    infos, state = S.run_port(integ, integ.init_state())
    return integ, infos, state


@pytest.mark.parametrize("k", range(S.STEPS))
def test_step_matches_jax(jax_run, port_run, k):
    S.check_step(jax_run["infos"], port_run[1], k)


@pytest.mark.parametrize("k", range(S.STEPS))
def test_port_alone_matches_jax(jax_run, port_alone, k):
    S.check_step(jax_run["infos"], port_alone[1], k)


def test_final_state_matches_jax(jax_run, port_run):
    S.check_final_state(jax_run, port_run[2])


def test_energy_falls_and_stays_finite(port_run):
    S.check_energy_falls(*port_run)


def test_convert_round_trip_and_own_constants(jax_run):
    S.check_round_trip(KW, jax_run)


def test_build_problem_routes_to_the_soa_engine(port_alone):
    integ = port_alone[0]
    assert type(integ).__name__ == "SoAADMM3D"
    assert integ.NFd == 768 and int(integ.valid.sum()) == 768
    assert integ.mesh.n_elements == 768
    assert integ.mesh.grid.constant == (1 == 0)


def test_run_loop_trace(jax_run, port_alone):
    """The run loop over the 3D engine: the trace holds the step energies
    (the JAX run's to rel 2e-6), and the target stop ends the run at the
    first step at or below the target."""
    integ = port_alone[0]
    state, trace, steps = run(integ, integ.init_state(), cap=S.STEPS, dt_tol=0.0)
    assert steps == S.STEPS and torch.isfinite(state.x).all()
    for k in range(S.STEPS):
        assert trace[k] == pytest.approx(jax_run["infos"][k][0], rel=2e-6)
    _, trace2, steps = run(integ, integ.init_state(), cap=S.STEPS, dt_tol=0.0,
                           target_ih=trace[1])
    assert steps == 2 and list(trace2[:2]) == list(trace[:2])
