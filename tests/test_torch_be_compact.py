"""Backward Euler on the compact path with the default ``neumann`` solve
(ROADMAP A12): the port's ``BackwardEulerIntegrator`` with
``ops/compact_eg.py`` against the JAX package's compact backward Euler
(``mmadmm_tpu/integrators/backward_euler.py:303-355, 404-420, 497-650``),
4 steps from the same state (``convert``), in float32 and float64, on
every configuration of ``tests/_torch_euler.py``: 3D SquareGrid, Shoulder
and CompSquare at nx=4, 2D SquareGrid at nx=8 and nx=20 (off the stencil
gate), 2D CompSquare at nx=8 (a computational mesh), a FromFile mesh
written with the JAX writers, and the LevelSet circle at nx=12.

Bands: the same Newton count at every step; float32 ``I_h`` within rtol
1e-5 and ``x`` within atol 1e-5 (the neumann band of
tests/test_krylov.py:90-93); float64 within rel 1e-10 and 1e-10.

About 60 s on one CPU, nearly all of it the JAX compiles."""

import numpy as np
import pytest

import _torch_euler as E
from _torch_threads import one_torch_thread  # noqa: F401

from mmadmm_tpu_torch.integrators.backward_euler import BackwardEulerIntegrator
from mmadmm_tpu_torch.ops.compact_eg import CompactEG

DTYPES = ["float32", "float64"]
BAND = {"float32": (1e-5, 1e-5), "float64": (1e-10, 1e-10)}  # (I_h rtol, x atol)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("fromfile"))
    E.write_fromfile(base)
    cache = {}

    def get(case, dtype):
        if (case, dtype) not in cache:
            kw = E.config(case, 2, dtype, base)
            with E.one_thread():
                _, s0, jax_out = E.jax_run(kw, E.STEPS)
                integ, port_out = E.port_run(kw, s0, E.STEPS)
            cache[case, dtype] = (jax_out, port_out, integ)
        return cache[case, dtype]

    return get


@pytest.mark.parametrize("k", range(E.STEPS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(E.CASES))
def test_step_matches_jax(runs, case, dtype, k):
    jax_out, port_out, _ = runs(case, dtype)
    ih_j, n_j, x_j, _ = jax_out[k]
    info, state = port_out[k]
    rtol, atol = BAND[dtype]
    assert info.n_newton == n_j
    assert info.ih == pytest.approx(ih_j, rel=rtol)
    np.testing.assert_allclose(state.x.numpy(), x_j, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(E.CASES))
def test_takes_the_compact_path(runs, case, dtype):
    """The compact path with the chord built each step and not carried."""
    _, port_out, integ = runs(case, dtype)
    assert type(integ) is BackwardEulerIntegrator and type(integ.eg) is CompactEG
    assert integ.krylov_solver == "neumann" and not integ.chord_carry
    ih = [info.ih for info, _ in port_out]
    assert np.isfinite(ih).all() and ih[-1] < ih[0]
    state = port_out[-1][1]
    assert state.He is None and state.dvec is None and state.steps == E.STEPS
