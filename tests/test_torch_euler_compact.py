"""Explicit Euler on the compact path (ROADMAP A11): the port's
``EulerIntegrator`` with ``ops/compact_eg.py`` against the JAX package's
compact Euler (``mmadmm_tpu/integrators/euler.py:111-124``), 4 steps from
the same state (``convert``), in float32 and float64, on every
configuration of ``tests/_torch_euler.py``: 3D SquareGrid, Shoulder and
CompSquare at nx=4, 2D SquareGrid at nx=8 and nx=20 (off the stencil
gate), 2D CompSquare at nx=8 (a computational mesh), a FromFile mesh
written with the JAX writers, and the LevelSet circle at nx=12.

Bands: float32 ``I_h`` within rtol 1e-6 and ``x`` within atol 1e-6 (the
band of tests/test_dense_eg2d.py:58-59); float64 within rel 1e-10 and
1e-10.

Also the port's two routes against each other: its 2D stencil Euler
(kernel K2's plain version) against its compact Euler at SquareGrid and
Shoulder nx=16, within the band of
tests/test_dense_eg2d.py::test_euler_grid_matches_stock.

About 20 s on one CPU."""

import numpy as np
import pytest

import _torch_euler as E
from _torch_threads import one_torch_thread  # noqa: F401

from mmadmm_tpu_torch import ExperimentConfig, build_problem
from mmadmm_tpu_torch.integrators.euler import EulerIntegrator
from mmadmm_tpu_torch.ops.compact_eg import CompactEG
from mmadmm_tpu_torch.ops.dense_eg2d import DenseEG2D

DTYPES = ["float32", "float64"]
BAND = {"float32": (1e-6, 1e-6), "float64": (1e-10, 1e-10)}  # (I_h rtol, x atol)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("fromfile"))
    E.write_fromfile(base)
    cache = {}

    def get(case, dtype):
        if (case, dtype) not in cache:
            kw = E.config(case, 1, dtype, base)
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
    ih_j, _, x_j, _ = jax_out[k]
    info, state = port_out[k]
    rtol, atol = BAND[dtype]
    assert info.ih == pytest.approx(ih_j, rel=rtol)
    np.testing.assert_allclose(state.x.numpy(), x_j, rtol=0, atol=atol)
    assert state.steps == k + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(E.CASES))
def test_takes_the_compact_path(runs, case, dtype):
    _, port_out, integ = runs(case, dtype)
    assert type(integ) is EulerIntegrator and type(integ.eg) is CompactEG
    ih = [info.ih for info, _ in port_out]
    assert np.isfinite(ih).all() and ih[-1] < ih[0]
    assert str(port_out[-1][1].x.dtype) == f"torch.{dtype}"


@pytest.mark.parametrize("test_type", ["SquareGrid", "Shoulder"])
def test_stencil_route_matches_compact(test_type):
    """The same mesh on both evaluators, 4 steps: I_h within rtol 1e-6, x
    within atol 1e-6."""
    kw = dict(E.BASE, test_type=test_type, dim=2, mon_type=1, method=1, nx=16, ny=16,
              dtype="float32")
    mesh, stencil = build_problem(ExperimentConfig(**kw), device="cpu")
    compact = EulerIntegrator(mesh, kw["dt"])
    assert type(stencil.eg) is DenseEG2D and type(compact.eg) is CompactEG
    out = []
    with E.one_thread():
        for integ in (stencil, compact):
            state, ihs = integ.init_state(), []
            for _ in range(E.STEPS):
                state, info = integ.step(state)
                ihs.append(info.ih)
            out.append((state.x.numpy(), np.asarray(ihs)))
    (x_s, ih_s), (x_c, ih_c) = out
    np.testing.assert_allclose(ih_s, ih_c, rtol=1e-6)
    np.testing.assert_allclose(x_s, x_c, rtol=0, atol=1e-6)
    assert np.isfinite(x_s).all()
