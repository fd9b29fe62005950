"""The slice end to end: the port's explicit Euler (method 1) and backward
Euler (method 2) on the stencil engine against the JAX package's, at
Shoulder nx=16, 4 steps each from the same state (``convert``). The JAX
side takes its kernel path as its own tests do (``MMADMM_EULER_GRID=1`` /
``MMADMM_BE_GRID=1``, ``make_be_kernels2d`` in interpreter mode on the
CPU, tests/test_dense_eg2d.py:25-45).

Bands: Euler Ih within rtol 1e-6 and x within atol 1e-6
(tests/test_dense_eg2d.py:54-58); backward Euler the same Newton count per
step, Ih within rtol 1e-5 (the neumann band of tests/test_krylov.py:93)
and x within atol 1e-5."""

import math
import os

import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.problems import build_problem as jax_build_problem

from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem, convert
from mmadmm_tpu_torch.integrators.backward_euler import BackwardEulerIntegrator
from mmadmm_tpu_torch.integrators.euler import EulerIntegrator
from mmadmm_tpu_torch.integrators.run_loop import run
from mmadmm_tpu_torch.ops.compact_eg import CompactEG
from mmadmm_tpu_torch.ops.dense_eg2d import DenseEG2D

STEPS = 4
KW = dict(test_type="Shoulder", dim=2, mon_type=1, nx=16, ny=16, dt=5e-3, tau=0.1,
          rho=50.0, dtype="float32")
ENV = {1: "MMADMM_EULER_GRID", 2: "MMADMM_BE_GRID"}


def _jax_integrator(method):
    key = ENV[method]
    old = os.environ.get(key)
    os.environ[key] = "1"
    try:
        jmesh, jinteg = jax_build_problem(JaxConfig(**KW, method=method))
    finally:
        if old is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = old
    if method == 1:
        assert jinteg._grid2d is not None, "JAX Euler did not take the kernel path"
    else:
        assert "eg" in jinteg._grid2d, "JAX backward Euler did not take the kernel path"
    return jmesh, jinteg


@pytest.fixture(scope="module", params=[1, 2], ids=["euler", "be"])
def runs(request):
    """Both packages, STEPS steps from the same state: ``(method, JAX
    [(ih, n_newton or None, x)], port [(info, x)], port integrator)``."""
    method = request.param
    _, jinteg = _jax_integrator(method)
    s = jinteg.init_state()
    _, integ = build_problem(ExperimentConfig(**KW, method=method), device="cpu")
    state = convert.load_euler_state(integ, dict(x=np.asarray(s.x)))
    jax_steps, port_steps = [], []
    for _ in range(STEPS):
        if method == 1:
            s, ih = jinteg.step(s)
            n = None
        else:  # the jitted step also returns the Newton count
            ns, ih, n = jinteg._step_jit(tuple(s), *jinteg._args)
            s, ih, n = type(s)(*ns), float(ih), int(n)
        jax_steps.append((ih, n, np.asarray(s.x)))
        state, info = integ.step(state)
        port_steps.append((info, state.x.numpy().copy()))
    return method, jax_steps, port_steps, integ


@pytest.mark.parametrize("k", range(STEPS))
def test_step_matches_jax(runs, k):
    """The step's energy in band and, for backward Euler, the same Newton
    count."""
    method, jax_steps, port_steps, _ = runs
    ih_j, n_j, _ = jax_steps[k]
    info = port_steps[k][0]
    assert info.ih == pytest.approx(ih_j, rel=1e-6 if method == 1 else 1e-5)
    if method == 2:
        assert info.n_newton == n_j


@pytest.mark.parametrize("k", range(STEPS))
def test_positions_match_jax(runs, k):
    method, jax_steps, port_steps, _ = runs
    np.testing.assert_allclose(port_steps[k][1], jax_steps[k][2], rtol=0,
                               atol=1e-6 if method == 1 else 1e-5)


def test_energy_falls_and_stays_finite(runs):
    _, _, port_steps, integ = runs
    ih = [info.ih for info, _ in port_steps]
    assert all(math.isfinite(v) for v in ih) and ih[-1] < ih[0]
    assert np.isfinite(port_steps[-1][1]).all()


def test_state_carries_previous_positions(runs):
    _, _, port_steps, integ = runs
    state = convert.load_euler_state(integ, dict(x=port_steps[0][1], steps=1))
    new, _ = integ.step(state)
    assert new.steps == 2 and torch.equal(new.x_prev, state.x)
    np.testing.assert_array_equal(new.x.numpy(), port_steps[1][1])


@pytest.mark.parametrize("method", [1, 2], ids=["euler", "be"])
def test_run_loop_dt_tol_stop(method):
    """DtTol on both methods: the first step never stops; a huge tolerance
    stops at the second; a zero tolerance runs to the cap."""
    _, integ = build_problem(ExperimentConfig(**KW, method=method), device="cpu")
    seen = []
    _, trace, steps = run(integ, integ.init_state(), cap=5, dt_tol=1e9,
                          on_step=lambda k, info: seen.append(k))
    assert steps == 2 and seen == [0, 1]
    assert np.isfinite(trace[:2]).all() and np.isnan(trace[2:]).all()
    _, trace, steps = run(integ, integ.init_state(), cap=3, dt_tol=0.0)
    assert steps == 3 and trace[2] < trace[0]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("test_type", ["SquareGrid", "Shoulder"])
@pytest.mark.parametrize("method,cls", [(1, EulerIntegrator), (2, BackwardEulerIntegrator)],
                         ids=["euler", "be"])
def test_build_problem_routes_to_the_stencil_engine(test_type, method, cls, dtype):
    """Both dtypes take the stencil engine, K2 and K3 built in the mesh's
    dtype (the float64 ones since ROADMAP A20, B8)."""
    kw = dict(KW, test_type=test_type, method=method, dtype=dtype)
    mesh, integ = build_problem(ExperimentConfig(**kw), device="cpu")
    assert type(integ) is cls
    assert integ.eg.NFd == 1024
    live = {"SquareGrid": 1024, "Shoulder": 768}[test_type]
    assert int(integ.eg.valid.sum()) == live == mesh.n_elements
    assert integ.eg.valid.dtype == integ.init_state().x.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("method,item", [(1, "A11"), (2, "A12")], ids=["euler", "be"])
@pytest.mark.parametrize("change,change_item", [(dict(n_devices=2), "torchrun")], ids=["sharded"])
def test_unported_routes_raise(method, item, change, change_item):
    """A sharded run (ROADMAP A15, ported since; ``tests/test_torch_spmd.py``
    runs it on ranks) built outside a rank group raises rather than run on
    one device."""
    kw = dict(KW, method=method, **change)
    with pytest.raises(RuntimeError, match=change_item or item):
        build_problem(ExperimentConfig(**kw), device="cpu")


@pytest.mark.parametrize("method,cls", [(1, EulerIntegrator), (2, BackwardEulerIntegrator)],
                         ids=["euler", "be"])
@pytest.mark.parametrize("change", [
    dict(test_type="LevelSet"), dict(nx=8, ny=8), dict(nx=8, ny=8, dtype="float64"),
], ids=["levelset", "off_gate", "off_gate_float64"])
def test_routes_off_the_stencil_engine_run_compact(method, cls, change):
    """Off the stencil engine (ROADMAP A11, A12; these cases raised before):
    the compact path, one finite step in the mesh's dtype."""
    mesh, integ = build_problem(ExperimentConfig(**dict(KW, method=method, **change)),
                                device="cpu")
    assert type(integ) is cls and type(integ.eg) is CompactEG
    state, info = integ.step(integ.init_state())
    assert math.isfinite(info.ih) and bool(torch.isfinite(state.x).all())
    assert state.x.dtype == mesh.dtype == getattr(torch, change.get("dtype", "float32"))


@pytest.mark.parametrize("option,engine", [
    (dict(krylov_solver="hess"), CompactEG), (dict(krylov_solver="cgstab"), CompactEG),
    (dict(precondition=True), DenseEG2D), (dict(chord_carry=True), DenseEG2D),
], ids=["hess", "cgstab", "precondition", "chord_carry"])
def test_be_options_build_and_step(option, engine):
    """Each option builds (ROADMAP A12; these cases raised before): a Krylov
    solver takes the compact path even on the stencil gate, as in the JAX
    package (backward_euler.py:184-190); ``precondition`` leaves the
    ``neumann`` solve on the stencil engine, and the chord carry keeps K3's
    triangle in the state. One finite step each; tests/test_torch_be_options.py
    holds them to the JAX package."""
    mesh, _ = build_problem(ExperimentConfig(**KW, method=2), device="cpu")
    integ = BackwardEulerIntegrator(mesh, 5e-3, grid2d_dims=(16, 16), **option)
    assert type(integ.eg) is engine
    state, info = integ.step(integ.init_state())
    assert math.isfinite(info.ih) and bool(torch.isfinite(state.x).all())
    if "chord_carry" in option:
        assert state.He.shape == (21, 1024) and state.dvec.shape == state.x.shape


def test_interior_nodes_match_jax():
    jmesh, _ = _jax_integrator(1)
    mesh, _ = build_problem(ExperimentConfig(**KW, method=1), device="cpu")
    np.testing.assert_array_equal(mesh.interior_nodes.numpy(),
                                  np.asarray(jmesh.interior_nodes))
