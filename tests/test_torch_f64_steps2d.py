"""The float64 stencil engines end to end in 2D: the port's GridADMM2D,
explicit Euler and backward Euler in float64 (kernels K1, K2 and K3 built
in float64; their plain versions on the CPU) against the JAX package's
own float64 stencil engines, which build their Pallas kernels in float64
(``MMADMM_GRID2D=1``, ``MMADMM_EULER_GRID=1``, ``MMADMM_BE_GRID=1``, the
kernels in interpreter mode; tests/test_torch_grid2d.py and
tests/test_torch_euler_be.py do the same in float32), at Shoulder nx=16,
both started from the same state through ``convert``.

Bands, float64: every step the same ADMM iteration count (Newton count
for backward Euler), ``I_h`` within rel 1e-10 (the generic route's band,
tests/test_torch_admm_generic.py) and the node positions within atol
1e-10 (O(1) positions). Measured on an Intel Xeon CPU: ``I_h`` within
6.7e-16 over 12 MM-ADMM steps and 3.3e-16 over 4 Euler and 4 backward
Euler steps, positions within 1.3e-15."""

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
from mmadmm_tpu_torch.integrators.backward_euler import BackwardEulerIntegrator
from mmadmm_tpu_torch.integrators.euler import EulerIntegrator

KW = dict(test_type="Shoulder", dim=2, mon_type=1, nx=16, ny=16, dt=5e-3, tau=0.1, rho=50.0,
          dtype="float64")
ADMM_STEPS, EULER_STEPS = 12, 4
# The JAX package's float64 GridADMM2D at this configuration, steps 0-2:
# (I_h, ADMM iterations), computed with JAX 0.9.0 on a CPU
JAX_FIRST_STEPS = [(0.34023077128533474, 4), (0.33341213661800273, 3),
                   (0.33200887517076133, 3)]


def _jax_problem(method, env):
    old = os.environ.get(env)
    os.environ[env] = "1"
    try:
        return jax_build_problem(JaxConfig(**KW, method=method))
    finally:
        if old is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = old


@pytest.fixture(scope="module")
def admm_runs():
    """Both packages' GridADMM2D over ADMM_STEPS steps from the same
    state: ``(JAX [(ih, n_iters)], JAX final x, port infos, port state)``."""
    jmesh, jinteg = _jax_problem(0, "MMADMM_GRID2D")
    assert type(jinteg).__name__ == "GridADMM2D"
    s0 = jinteg.init_state()
    assert np.asarray(s0.x).dtype == np.float64
    s, jax_steps = s0, []
    for _ in range(ADMM_STEPS):
        s, info = jinteg.step(s)
        jax_steps.append((float(info.ih_start), int(info.n_iters)))
    _, integ = build_problem(ExperimentConfig(**KW, method=0), device="cpu")
    c = jinteg._consts
    convert.load_grid2d_consts(integ, dict(
        swap_k=np.asarray(c["swap_k"]), alive_k=np.asarray(c["alive_k"]),
        valid_t=np.asarray(c["valid_t"]), free_t=np.asarray(c["free_t"]),
        cell_table=np.asarray(c["cell_table"]),
        axes=[np.asarray(a) for a in c["axes"]], ehat=np.asarray(jmesh.ehat),
    ))
    state = convert.load_grid2d_state(integ, dict(
        x=np.asarray(s0.x), x_prev=np.asarray(s0.x_prev), u=np.asarray(s0.u)))
    assert state.x.dtype == state.u.dtype == torch.float64
    np.testing.assert_array_equal(state.x.numpy(), np.asarray(s0.x))
    infos = []
    for _ in range(ADMM_STEPS):
        state, info = integ.step(state)
        infos.append(info)
    return jax_steps, np.asarray(s.x), infos, state


def test_jax_reference_takes_its_float64_values(admm_runs):
    """The JAX package's float64 stencil engine gives the values recorded
    for it (a check on the reference side)."""
    for (ih, it), (ref, ref_it) in zip(admm_runs[0], JAX_FIRST_STEPS):
        assert it == ref_it and ih == pytest.approx(ref, rel=1e-12)


@pytest.mark.parametrize("k", range(ADMM_STEPS))
def test_grid2d_step_matches_jax_in_float64(admm_runs, k):
    ih_j, it_j = admm_runs[0][k]
    info = admm_runs[2][k]
    assert info.n_iters == it_j
    assert info.ih == pytest.approx(ih_j, rel=1e-10)


def test_grid2d_final_state_matches_jax_in_float64(admm_runs):
    _, x_j, infos, state = admm_runs
    assert state.x.dtype == state.u.dtype == torch.float64
    np.testing.assert_allclose(state.x.numpy(), x_j, rtol=0, atol=1e-10)
    ih = [i.ih for i in infos]
    assert all(math.isfinite(v) for v in ih) and ih[-1] < ih[0]


@pytest.fixture(scope="module", params=[1, 2], ids=["euler", "be"])
def euler_runs(request):
    """Both packages' explicit or backward Euler over EULER_STEPS steps
    from the same state: ``(method, JAX [(ih, n_newton or None, x)], port
    [(info, x)])``."""
    method = request.param
    _, jinteg = _jax_problem(method, "MMADMM_EULER_GRID" if method == 1 else "MMADMM_BE_GRID")
    assert jinteg._grid2d is not None and (method == 1 or "eg" in jinteg._grid2d)
    s = jinteg.init_state()
    _, integ = build_problem(ExperimentConfig(**KW, method=method), device="cpu")
    state = convert.load_euler_state(integ, dict(x=np.asarray(s.x)))
    assert state.x.dtype == torch.float64
    jax_steps, port_steps = [], []
    for _ in range(EULER_STEPS):
        if method == 1:
            s, ih = jinteg.step(s)
            n = None
        else:  # the jitted step also returns the Newton count
            ns, ih, n = jinteg._step_jit(tuple(s), *jinteg._args)
            s, ih, n = type(s)(*ns), float(ih), int(n)
        jax_steps.append((float(ih), n, np.asarray(s.x)))
        state, info = integ.step(state)
        port_steps.append((info, state.x.numpy().copy()))
    return method, jax_steps, port_steps


@pytest.mark.parametrize("k", range(EULER_STEPS))
def test_euler_step_matches_jax_in_float64(euler_runs, k):
    method, jax_steps, port_steps = euler_runs
    ih_j, n_j, x_j = jax_steps[k]
    info, x = port_steps[k]
    assert info.ih == pytest.approx(ih_j, rel=1e-10)
    if method == 2:
        assert info.n_newton == n_j
    assert x.dtype == np.float64
    np.testing.assert_allclose(x, x_j, rtol=0, atol=1e-10)


@pytest.mark.parametrize("method,cls", [(0, GridADMM2D), (1, EulerIntegrator),
                                        (2, BackwardEulerIntegrator)],
                         ids=["admm", "euler", "be"])
def test_float64_box_meshes_take_the_stencil_engine(method, cls):
    mesh, integ = build_problem(ExperimentConfig(**KW, method=method), device="cpu")
    assert type(integ) is cls and mesh.dtype == torch.float64
    free = integ.free if method == 0 else integ.eg.valid
    assert free.dtype == torch.float64 and integ.init_state().x.dtype == torch.float64
