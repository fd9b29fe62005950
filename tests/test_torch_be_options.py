"""The backward-Euler options (ROADMAP A12) and ``ops/krylov.py`` against
the JAX package.

* Each option at 2D SquareGrid nx=8 in float64, dt 0.2 (so that Newton
  takes two iterations at steps 0-2), from the same state, port against
  the JAX package's same option: the inner solvers ``hess``, ``cgstab``,
  ``cg`` and ``scipy`` and ``precondition=True`` with ``cgstab`` over 4
  steps (the port's ``cgstab`` and ``cg`` run all 40 masked trips of
  every solve, as the JAX ``fori_loop`` does), and the chord carry
  (``chord_carry=True, rebuild_at=3``; the JAX package's
  ``MMADMM_BE_CHORD=1, MMADMM_BE_REBUILD=3``) over 8, the whole JAX
  state loaded by ``convert.load_be_state``. The same Newton count and
  rebuild flag at every step, ``I_h`` within rel 1e-9 and ``x`` within
  1e-9. The chord carry's run takes a rebuild and keeps a carry, and a run
  resumed from the JAX state of step 6 (its carried ``He`` and ``dvec``)
  gives step 7 again.
* The chord carry on the 2D stencil engine (K3's plain version) against
  the JAX package's stencil chord carry (``MMADMM_BE_GRID=1``) at Shoulder
  nx=16, dt 5e-3, rebuild_at 2, 8 steps, in float32 and float64: the same
  Newton counts and rebuild flags, ``I_h`` within rtol 1e-5 and ``x``
  within 1e-5 (the neumann band: the JAX chord there is the compact
  forward derivative, the port's K3 with its 1e-9 Levenberg term); and
  resumed from a JAX state with a carried chord, through the slot mapping
  of ``load_be_state``.
* The port's own solver agreement, as tests/test_krylov.py:62-93 holds the
  JAX package's: ``cg``, ``scipy`` and ``hess`` against ``cgstab`` within
  rtol 1e-9, ``neumann`` within 1e-5.
* ``ops/krylov.py`` alone on the systems of tests/test_krylov.py:19-60
  against the JAX module: the same iterates within rel 1e-10 and the same
  iteration counts; ``scipy_bicgstab`` against
  ``jax.scipy.sparse.linalg.bicgstab``.

About 100 s on one CPU."""

import jax.numpy as jnp
import jax.scipy.sparse.linalg as jsla
import numpy as np
import pytest
import torch

import _torch_euler as E
from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu.ops import krylov as jax_krylov

from mmadmm_tpu_torch import convert
from mmadmm_tpu_torch.ops import krylov
from mmadmm_tpu_torch.ops.compact_eg import CompactEG
from mmadmm_tpu_torch.ops.dense_eg2d import DenseEG2D

STEPS = 8  # the chord carry's and the stencil chord carry's steps
KRYLOV_STEPS = 4  # the inner solvers' steps
KW = dict(E.config("square2d_8", 2, "float64"), dt=0.2)
CHORD = dict(chord_carry=True, rebuild_at=3)
# name: (JAX constructor options, JAX environment, port options, steps)
OPTIONS = {
    "neumann": (None, None, None, KRYLOV_STEPS),
    "hess": (dict(krylov_solver="hess"), None, dict(krylov_solver="hess"), KRYLOV_STEPS),
    "cgstab": (dict(krylov_solver="cgstab"), None, dict(krylov_solver="cgstab"), KRYLOV_STEPS),
    "cg": (dict(krylov_solver="cg"), None, dict(krylov_solver="cg"), KRYLOV_STEPS),
    "scipy": (dict(krylov_solver="scipy"), None, dict(krylov_solver="scipy"), KRYLOV_STEPS),
    "precondition_cgstab": (dict(krylov_solver="cgstab", precondition=True), None,
                            dict(krylov_solver="cgstab", precondition=True), KRYLOV_STEPS),
    "chord_carry": (None, {"MMADMM_BE_CHORD": 1, "MMADMM_BE_REBUILD": 3}, CHORD, STEPS),
}
OPTION_STEPS = [(o, k) for o, (*_, steps) in OPTIONS.items() if o != "neumann"
                for k in range(steps)]
# the stencil engine's chord carry: Shoulder nx=16 on the stencil gate
GRID_KW = dict(E.BASE, test_type="Shoulder", dim=2, mon_type=1, nx=16, ny=16, method=2)
GRID_ENV = {"MMADMM_BE_GRID": 1, "MMADMM_BE_CHORD": 1, "MMADMM_BE_REBUILD": 2}
GRID_OPTS = dict(grid2d_dims=(16, 16), chord_carry=True, rebuild_at=2)


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            jopt, environ, popt, steps = OPTIONS[name]
            with E.one_thread():
                _, s0, jax_out = E.jax_run(KW, steps, jopt, environ)
                integ, port_out = E.port_run(KW, s0, steps, popt, chord=name == "chord_carry")
            cache[name] = (jax_out, port_out, integ)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def grid_runs():
    cache = {}

    def get(dtype):
        if dtype not in cache:
            kw = dict(GRID_KW, dtype=dtype)
            with E.one_thread():
                _, s0, jax_out = E.jax_run(kw, STEPS, None, GRID_ENV, stencil=True)
                integ, port_out = E.port_run(kw, s0, STEPS, GRID_OPTS, chord=True)
            cache[dtype] = (jax_out, port_out, integ)
        return cache[dtype]

    return get


@pytest.mark.parametrize("name,k", OPTION_STEPS)
def test_option_matches_jax(runs, name, k):
    jax_out, port_out, integ = runs(name)
    ih_j, n_j, x_j, s_j = jax_out[k]
    info, state = port_out[k]
    assert type(integ.eg) is CompactEG
    assert info.n_newton == n_j and state.rebuild == bool(s_j.rebuild)
    assert info.ih == pytest.approx(ih_j, rel=1e-9)
    np.testing.assert_allclose(state.x.numpy(), x_j, rtol=0, atol=1e-9)


def _carries(port_out):
    """For each step after the first: whether it kept the carried chord
    (the same ``He`` tensor as the step before), and that it did so
    exactly when the step before did not flag a rebuild."""
    kept = []
    for (_, prev), (_, state) in zip(port_out, port_out[1:]):
        carried = state.He is prev.He
        assert carried == (not prev.rebuild)
        assert (state.dvec is prev.dvec) == carried
        kept.append(carried)
    return kept


def test_chord_carry_rebuilds_and_carries(runs):
    """The chord rides the state: a step after a rebuild flag builds a new
    one, any other step keeps it; the run here does both."""
    _, port_out, integ = runs("chord_carry")
    assert integ.chord_carry and integ.rebuild_at == 3
    kept = _carries(port_out)
    assert any(kept) and not all(kept)
    assert all(state.He.shape == (64 * 4, 6, 6) for _, state in port_out)


def test_chord_carry_resumes_from_jax_state(runs):
    """Step 7 again from the JAX state after step 6, its carried ``He``
    and ``dvec`` loaded by ``convert.load_be_state``."""
    jax_out, _, integ = runs("chord_carry")
    s6 = jax_out[6][3]
    assert not bool(s6.rebuild), "step 7 must keep the carried chord"
    state = convert.load_be_state(integ, {k: np.asarray(v) for k, v in s6._asdict().items()})
    np.testing.assert_array_equal(state.He.numpy(), np.asarray(s6.He))
    new, info = integ.step(state)
    ih_j, n_j, x_j, _ = jax_out[7]
    assert new.He is state.He and info.n_newton == n_j
    assert info.ih == pytest.approx(ih_j, rel=1e-10)
    np.testing.assert_allclose(new.x.numpy(), x_j, rtol=0, atol=1e-10)


@pytest.mark.parametrize("k", range(STEPS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_stencil_chord_carry_matches_jax(grid_runs, dtype, k):
    jax_out, port_out, integ = grid_runs(dtype)
    ih_j, n_j, x_j, s_j = jax_out[k]
    info, state = port_out[k]
    assert type(integ.eg) is DenseEG2D and state.He.shape == (21, 1024)
    assert info.n_newton == n_j and state.rebuild == bool(s_j.rebuild)
    assert info.ih == pytest.approx(ih_j, rel=1e-5)
    np.testing.assert_allclose(state.x.numpy(), x_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_stencil_chord_carry_resumes_from_jax_state(grid_runs, dtype):
    """The JAX stencil engine's carried ``He [NF, 6, 6]`` goes into the
    port's slot triangle: a step again from the JAX state before it, at
    the first step from step 4 on that keeps the carried chord."""
    jax_out, port_out, integ = grid_runs(dtype)
    assert _carries(port_out).count(True) >= 2
    k = next(k for k in range(3, STEPS - 1) if not bool(jax_out[k][3].rebuild))
    s = jax_out[k][3]
    state = convert.load_be_state(integ, {f: np.asarray(v) for f, v in s._asdict().items()})
    m = integ.eg.mesh_of_dense
    He = np.asarray(s.He)
    np.testing.assert_array_equal(state.He[5, m >= 0].numpy(), He[m[m >= 0], 2, 2])
    assert bool((state.He[:, m < 0] == 0).all())
    with E.one_thread():
        new, info = integ.step(state)
    ih_j, n_j, x_j, _ = jax_out[k + 1]
    assert new.He is state.He and info.n_newton == n_j
    assert info.ih == pytest.approx(ih_j, rel=1e-5)
    np.testing.assert_allclose(new.x.numpy(), x_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("solver", ["cg", "scipy", "hess", "neumann"])
def test_solver_agreement(runs, solver):
    """The port's solvers against its ``cgstab``: exact inner solves agree
    to 1e-9, the chord ``neumann`` to its inexact-solve band 1e-5."""
    ref = [info.ih for info, _ in runs("cgstab")[1]]
    got = [info.ih for info, _ in runs(solver)[1]]
    np.testing.assert_allclose(got, ref, rtol=1e-5 if solver == "neumann" else 1e-9, atol=0)


def _random_spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def _nonsymmetric(n=40):
    rng = np.random.default_rng(2)
    return rng.standard_normal((n, n)) * 0.1 + np.eye(n) * 4.0, rng.standard_normal(n)


def _both(solver, A, b, **kw):
    """``(port x, port iterations, JAX x, JAX iterations)``."""
    At = torch.tensor(A)
    x, (it, _) = getattr(krylov, solver)(lambda v: At @ v, torch.tensor(b), **kw)
    Aj = jnp.asarray(A)
    xj, (itj, _) = getattr(jax_krylov, solver)(lambda v: Aj @ v, jnp.asarray(b), **kw)
    return x.numpy(), int(it), np.asarray(xj), int(itj)


@pytest.mark.parametrize("case", ["cg_spd", "bicgstab_nonsymmetric", "bicgstab_freeze_30",
                                  "bicgstab_freeze_300", "bicgstab_zero_rhs"])
def test_krylov_matches_jax(case):
    if case == "cg_spd":
        A, b = _random_spd(40, 0), np.random.default_rng(1).standard_normal(40)
        x, it, xj, itj = _both("cg", A, b, tol=1e-12, maxiter=200)
        np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-8, atol=1e-8)
    elif case == "bicgstab_nonsymmetric":
        A, b = _nonsymmetric()
        x, it, xj, itj = _both("bicgstab", A, b, tol=1e-12, maxiter=200)
        np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-7, atol=1e-8)
    elif case.startswith("bicgstab_freeze"):
        # trips past convergence change nothing (the masked no-op)
        A, b = _random_spd(16, 3), np.random.default_rng(4).standard_normal(16)
        x, it, xj, itj = _both("bicgstab", A, b, tol=1e-10, maxiter=int(case.split("_")[-1]))
        x30 = _both("bicgstab", A, b, tol=1e-10, maxiter=30)[0]
        np.testing.assert_array_equal(x, x30)
    else:
        A, b = _random_spd(8, 5), np.zeros(8)
        x, it, xj, itj = _both("bicgstab", A, b)
        np.testing.assert_array_equal(x, np.zeros(8))
    assert it == itj and it < 200
    np.testing.assert_allclose(x, xj, rtol=1e-10, atol=1e-14)


def test_scipy_bicgstab_matches_jax():
    A, b = _nonsymmetric()
    At, Aj = torch.tensor(A), jnp.asarray(A)
    for tol, maxiter in ((1e-6, 40), (1e-12, 200), (1e-12, 3)):
        x = krylov.scipy_bicgstab(lambda v: At @ v, torch.tensor(b), tol=tol, maxiter=maxiter)
        xj, _ = jsla.bicgstab(lambda v: Aj @ v, jnp.asarray(b), tol=tol, maxiter=maxiter)
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-14)
