"""The stock engine on the generic route (``ops/prox.py``, the JAX
package's default) against the JAX package's ``ADMMIntegrator`` with
``prox_backend="vmap"``, both started from the same state through
``mmadmm_tpu_torch.convert.load_admm_state``.

Cases:

* 2D SquareGrid nx=8 in float64 over 12 steps, with the chord Jacobian
  carried across prox calls (``j_carry=True``) and rebuilt at every call
  (``j_carry=False``), as tests/test_jcarry.py:15-19 runs them;
* 3D SquareGrid nx=4 on its computational mesh (CompSquare, MonType 5,
  rho 10) in float64 over 4 steps;
* a 2D computational mesh, SquareGrid nx=8, MonType 5, rho 10, in float64
  and float32 over 12 steps (the port's only route for it: K1 has no
  computational-mesh mode);
* the LevelSet circle of tests/test_harness.py:161-164 in float64 over 6
  steps.

Bands: the same ``n_iters`` at every step, and ``steps``, ``rose`` and
``rises`` equal. In float64, ``I_h`` within rel 1e-10 and ``x`` within
1e-10. In float32, the bands of tests/test_torch_admm_stock.py: ``I_h``
within rel 2e-6 and ``x`` within 2e-6, or within how far the JAX
package's own float32 run is from its float64 run at that step, if that
is more: on the 2D computational mesh both packages' float32 runs drift
from the float64 trajectory by 3.2e-6 by step 12, and apart from each
other by 2.0e-6 (the rounding of two float32 implementations, not a
fault).

Also here: ``Experiments/InputFiles/Monitor3320r.json`` as a user loads
it (float64, ``prox_backend="auto"``) builds the stock engine on the
generic route with the carried Jacobian, and its step-0 ``I_h`` is the
JAX package's 0.1713965975485735 within rtol 1e-12.
"""

import math
import os

import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.integrators.admm import ADMMIntegrator as JaxADMM
from mmadmm_tpu.problems import build_problem as jax_build_problem

from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem, convert, load_experiment_config
from mmadmm_tpu_torch.integrators.admm import ADMMIntegrator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M3320R = os.path.join(REPO, "Experiments", "InputFiles", "Monitor3320r.json")
JAX_M3320R_IH0 = 0.1713965975485735  # the JAX package, float64, vmap route, CPU
X_ATOL32 = 2e-6

_SQ2 = dict(test_type="SquareGrid", dim=2, mon_type=1, method=0, nx=8, ny=8, dt=5e-3, tau=0.1,
            rho=50.0)
_COMP2 = dict(test_type="SquareGrid", dim=2, mon_type=5, method=0, nx=8, ny=8, dt=5e-3,
              tau=0.1, rho=10.0, comp_mesh=True)
# name: (config, steps, j_carry)
CASES = {
    "square2d_carry": (_SQ2, 12, True),
    "square2d_rebuild": (_SQ2, 12, False),
    "compsquare3d": (dict(test_type="SquareGrid", dim=3, mon_type=5, method=0, nx=4, ny=4,
                          nz=4, dt=5e-3, tau=0.1, rho=10.0, comp_mesh=True), 4, None),
    "comp2d_f64": (_COMP2, 12, None),
    "comp2d_f32": (dict(_COMP2, dtype="float32", prox_backend="vmap"), 12, None),
    "levelset": (dict(name="circle", test_type="LevelSet", dim=2, mon_type=0, method=0, nx=12,
                      ny=12, n_steps=6, dt=1e-4, tau=0.1, rho=50.0, dt_tol=1e-12), 6, None),
}
STEP_CASES = [(c, k) for c, (_, steps, _) in CASES.items() for k in range(steps)]


def _jax_run(kw, steps, j_carry):
    """The JAX stock engine on its vmap route over ``steps`` steps, as
    NumPy: the start state and per step ``(ih, n_iters, x, steps, rose,
    rises, J)``."""
    jmesh, jinteg = jax_build_problem(JaxConfig(**kw))
    assert type(jinteg).__name__ == "ADMMIntegrator" and jmesh.prox_backend == "vmap"
    if j_carry is not None:
        jinteg = JaxADMM(jmesh, kw["dt"], admm_iters=jinteg.admm_iters, tol=jinteg.tol,
                         j_carry=j_carry)
    s0 = jinteg.init_state()
    s, out = s0, []
    for _ in range(steps):
        s, info = jinteg.step(s)
        out.append((float(info.ih_start), int(info.n_iters), np.asarray(s.x), int(s.steps),
                    bool(s.rose), int(s.rises), np.asarray(s.J)))
    start = dict(x=np.asarray(s0.x), x_prev=np.asarray(s0.x_prev), u_bar=np.asarray(s0.u_bar),
                 J=np.asarray(s0.J), j_fresh=bool(s0.j_fresh))
    return jinteg.j_carry, start, out


@pytest.fixture(scope="module")
def runs():
    """Each case's JAX and port runs, computed once on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            kw, steps, j_carry = CASES[case]
            jc, start, jax_out = _jax_run(kw, steps, j_carry)
            mesh, integ = build_problem(ExperimentConfig(**kw), device="cpu")
            if j_carry is not None:
                integ = ADMMIntegrator(mesh, kw["dt"], admm_iters=integ.admm_iters,
                                       tol=integ.tol, j_carry=j_carry)
            state = convert.load_admm_state(integ, start)
            port_out = []
            for _ in range(steps):
                state, info = integ.step(state)
                port_out.append((info, state))
            # the JAX package's float64 run of a float32 case: how far its own
            # float32 run is from it, step by step
            gap = None
            if kw.get("dtype") == "float32":
                ref = _jax_run(dict(kw, dtype="float64"), steps, j_carry)[2]
                gap = [float(np.abs(a[2] - b[2]).max()) for a, b in zip(jax_out, ref)]
            cache[case] = dict(kw=kw, jax=jax_out, port=port_out, integ=integ, mesh=mesh,
                               start=start, j_carry=jc, gap=gap)
        return cache[case]

    return get


@pytest.mark.parametrize("case,k", STEP_CASES)
def test_step_matches_jax(runs, case, k):
    r = runs(case)
    ih_j, it_j, x_j, steps_j, rose_j, rises_j, _ = r["jax"][k]
    info, state = r["port"][k]
    assert info.n_iters == it_j
    assert (state.steps, state.rose, state.rises) == (steps_j, rose_j, rises_j)
    if r["gap"] is None:  # float64
        ih_tol, x_tol = 1e-10 * abs(ih_j), 1e-10
    else:
        ih_tol, x_tol = 2e-6 * abs(ih_j), max(X_ATOL32, r["gap"][k])
    assert abs(info.ih - ih_j) <= ih_tol
    np.testing.assert_allclose(state.x.numpy(), x_j, rtol=0, atol=x_tol)


@pytest.mark.parametrize("case", list(CASES))
def test_routes_to_the_generic_prox_and_carries_j_as_jax(runs, case):
    """The stock engine on the generic route, with the JAX package's carry
    decision (auto: carried while it fits 400 MiB), the same ``J`` shapes
    and, in float64 on the SquareGrid, the same carried ``J`` within 1e-10
    of its largest entry."""
    r = runs(case)
    integ, mesh = r["integ"], r["mesh"]
    assert isinstance(integ, ADMMIntegrator) and mesh.prox_backend == "vmap"
    assert integ.j_carry == r["j_carry"]
    assert mesh.comp_mesh == bool(r["kw"].get("comp_mesh"))
    for (info, state), j in zip(r["port"], r["jax"]):
        assert tuple(state.J.shape) == j[6].shape and not state.j_fresh
    if case == "square2d_carry":
        for (_, state), j in zip(r["port"], r["jax"]):
            scale = np.abs(j[6]).max()
            np.testing.assert_allclose(state.J.numpy(), j[6], rtol=0, atol=1e-10 * scale)


@pytest.mark.parametrize("case", list(CASES))
def test_energy_falls_and_stays_finite(runs, case):
    r = runs(case)
    ih = [info.ih for info, _ in r["port"]]
    state = r["port"][-1][1]
    assert all(math.isfinite(v) for v in ih) and ih[-1] < ih[0]
    assert torch.isfinite(state.x).all()
    if case == "levelset":  # tests/test_harness.py:180-181: monotone from the first step
        assert all(b < a for a, b in zip(ih, ih[1:]))


def test_load_admm_state_carries_j():
    """``convert.load_admm_state`` takes the JAX state's ``J`` and
    ``j_fresh``, and checks the shape."""
    kw = dict(_SQ2)
    _, integ = build_problem(ExperimentConfig(**kw), device="cpu")
    rng = np.random.default_rng(5)
    nf = integ.mesh.n_elements
    x = integ.mesh._X_np
    arrays = dict(x=x, x_prev=x, u_bar=np.zeros((nf, 3, 2)), J=rng.normal(size=(nf, 6, 6)),
                  j_fresh=False)
    state = convert.load_admm_state(integ, arrays)
    np.testing.assert_array_equal(state.J.numpy(), arrays["J"])
    assert state.j_fresh is False
    with pytest.raises(ValueError, match="J"):
        convert.load_admm_state(integ, dict(arrays, J=np.zeros((nf, 12, 12))))


def test_monitor3320r_runs_as_loaded():
    """The shipped config as a user loads it: float64, ``"auto"``, the
    stock engine on the generic route with the carried Jacobian (265,004 x
    36 x 8 B = 76 MB), and the JAX package's step-0 ``I_h``. A step's
    ``I_h`` is the energy at its first prox call's input, whatever the
    number of ADMM iterations and prox sweeps that follow, so the step here
    runs one of each (a CPU runs the whole step 0 in some 25 s alone);
    ``chip_smoke.py`` runs the whole steps 0 and 1 on the card against the
    JAX package's ``I_h`` and ADMM counts (5 and 3)."""
    cfg = load_experiment_config(M3320R)
    assert cfg.dtype == "float64" and cfg.prox_backend == "auto"
    mesh, integ = build_problem(cfg, device="cpu")
    assert isinstance(integ, ADMMIntegrator)
    assert (mesh.prox_backend, mesh.dtype, integ.j_carry) == ("vmap", torch.float64, True)
    assert (mesh.n_pnts, mesh.n_elements) == (133_116, 265_004)
    assert float(mesh.energy(mesh.X0)) == pytest.approx(JAX_M3320R_IH0, rel=1e-12)
    one = ADMMIntegrator(mesh, cfg.dt, admm_iters=1, tol=integ.tol, prox_max_iters=1)
    state, info = one.step(one.init_state())
    assert info.ih == pytest.approx(JAX_M3320R_IH0, rel=1e-12)
    assert info.n_iters == 1 and not state.j_fresh
    assert tuple(state.J.shape) == (265_004, 6, 6) and bool(torch.isfinite(state.J).all())
