"""The slice end to end: the port's GridADMM2D against the JAX package's
GridADMM2D (``MMADMM_GRID2D=1``, ``prox_backend="pallas"`` in interpreter
mode, the pattern of tests/test_grid2d.py:25-58) at Shoulder nx=16, both
started from the same state through ``mmadmm_tpu_torch.convert``.

Bands: ``n_iters`` identical; the step energy ``ih`` within rel 1e-6. The JAX
package's own stock-vs-grid band is 1e-7; the port adds in f64 where JAX
adds f32 blocks, and XLA and PyTorch order f32 operations differently."""

import math
import os

import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.problems import build_problem as jax_build_problem

from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem, convert
from mmadmm_tpu_torch.integrators.admm_grid2d import GridADMM2D
from mmadmm_tpu_torch.integrators.run_loop import run

STEPS = 12
KW = dict(test_type="Shoulder", dim=2, mon_type=1, method=0, nx=16, ny=16,
          dt=5e-3, tau=0.1, rho=50.0, dtype="float32")


@pytest.fixture(scope="module")
def jax_run():
    old = os.environ.get("MMADMM_GRID2D")
    os.environ["MMADMM_GRID2D"] = "1"
    try:
        jmesh, jinteg = jax_build_problem(JaxConfig(**KW, prox_backend="pallas"))
    finally:
        if old is None:
            os.environ.pop("MMADMM_GRID2D", None)
        else:
            os.environ["MMADMM_GRID2D"] = old
    assert type(jinteg).__name__ == "GridADMM2D"
    s0 = jinteg.init_state()
    s, infos = s0, []
    for _ in range(STEPS):
        s, info = jinteg.step(s)
        infos.append((float(info.ih_start), int(info.n_iters)))
    return jmesh, jinteg, s0, infos, s


def _port_from_jax(jmesh, jinteg, s0):
    _, integ = build_problem(ExperimentConfig(**KW), device="cpu")
    c = jinteg._consts
    convert.load_grid2d_consts(integ, dict(
        swap_k=np.asarray(c["swap_k"]), alive_k=np.asarray(c["alive_k"]),
        valid_t=np.asarray(c["valid_t"]), free_t=np.asarray(c["free_t"]),
        cell_table=np.asarray(c["cell_table"]),
        axes=[np.asarray(a) for a in c["axes"]], ehat=np.asarray(jmesh.ehat),
    ))
    state = convert.load_grid2d_state(integ, dict(
        x=np.asarray(s0.x), x_prev=np.asarray(s0.x_prev), u=np.asarray(s0.u)))
    return integ, state


@pytest.fixture(scope="module")
def port_run(jax_run):
    jmesh, jinteg, s0, _, _ = jax_run
    integ, state = _port_from_jax(jmesh, jinteg, s0)
    infos = []
    for _ in range(STEPS):
        state, info = integ.step(state)
        infos.append(info)
    return integ, infos, state


@pytest.mark.parametrize("k", range(STEPS))
def test_step_matches_jax(jax_run, port_run, k):
    ih_j, it_j = jax_run[3][k]
    info = port_run[1][k]
    assert info.n_iters == it_j
    assert info.ih == pytest.approx(ih_j, rel=1e-6)


def test_final_state_matches_jax(jax_run, port_run):
    """After STEPS steps the mesh agrees to f32 round-off (positions are
    O(1); 1e-5 absolute is ~100 f32 ulps of accumulated reordering)."""
    s_j, s_p = jax_run[4], port_run[2]
    np.testing.assert_allclose(s_p.x.numpy(), np.asarray(s_j.x), rtol=0, atol=1e-5)
    assert s_p.steps == int(s_j.steps) and s_p.rises == int(s_j.rises)
    assert s_p.rose == bool(s_j.rose)


def test_energy_falls_and_stays_finite(port_run):
    integ, infos, state = port_run
    ih = [i.ih for i in infos]
    assert all(math.isfinite(v) for v in ih) and ih[-1] < ih[0]
    assert torch.isfinite(state.x).all()
    assert integ.energy(state) < ih[0]


def test_convert_round_trip(jax_run):
    """convert loads the JAX state into the port's layout unchanged."""
    jmesh, jinteg, s0, _, _ = jax_run
    integ, state = _port_from_jax(jmesh, jinteg, s0)
    np.testing.assert_array_equal(state.x.numpy(), np.asarray(s0.x))
    np.testing.assert_array_equal(state.u.numpy(), np.asarray(s0.u).reshape(6, -1))
    np.testing.assert_array_equal(integ.free.numpy(),
                                  np.asarray(jinteg._consts["free_t"]).reshape(6, -1))
    assert state.steps == 0 and state.ih_last == math.inf


@pytest.fixture(scope="module")
def port_alone():
    mesh, integ = build_problem(ExperimentConfig(**KW), device="cpu")
    return integ


def test_build_problem_routes_to_the_stencil_engine(port_alone):
    assert isinstance(port_alone, GridADMM2D)
    assert port_alone.NFd == 1024 and int(port_alone.valid.sum()) == 768


def test_run_loop_trace_and_cap(port_alone, jax_run):
    """A capped run: the trace holds the step energies (the JAX run's to
    rel 1e-6), NaN after the last step."""
    state, trace, steps = run(port_alone, port_alone.init_state(), cap=STEPS + 2,
                              dt_tol=0.0)
    assert steps == STEPS + 2 and trace.shape == (STEPS + 2,)
    np.testing.assert_allclose(trace[:STEPS], [ih for ih, _ in jax_run[3]], rtol=1e-6)
    state, trace, steps = run(port_alone, port_alone.init_state(), cap=6, dt_tol=0.0,
                              target_ih=trace[1])
    assert steps == 2 and np.isnan(trace[2:]).all()


def test_run_loop_dt_tol_stop(port_alone):
    """DtTol: the first step never stops; a huge tolerance stops at the
    second."""
    seen = []
    _, trace, steps = run(port_alone, port_alone.init_state(), cap=5, dt_tol=1e9,
                          on_step=lambda k, info: seen.append((k, info.n_iters)))
    assert steps == 2 and [k for k, _ in seen] == [0, 1]
    assert np.isfinite(trace[:2]).all() and np.isnan(trace[2:]).all()


def test_run_loop_nan_stop():
    class Nan:
        dt = 1.0

        def step(self, state):
            return state, type("I", (), {"ih": float("nan")})()

    _, trace, steps = run(Nan(), None, cap=4, dt_tol=0.0)
    assert steps == 1 and np.isnan(trace).all()
