"""Shared set-up of the compact explicit- and backward-Euler tests
(tests/test_torch_euler_compact.py, tests/test_torch_be_compact.py,
tests/test_torch_be_options.py): the configurations, and one run of each
package from the same state (``convert``), as NumPy.

The JAX side runs its own default route, the compact path, at every
configuration here: 3D meshes, computational, FromFile and LevelSet
meshes, and 2D boxes below its stencil engine's 50,000-element gate, so
no Pallas kernel is interpreted."""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.geometry import io as jax_io
from mmadmm_tpu.integrators.backward_euler import BackwardEulerIntegrator as JaxBE
from mmadmm_tpu.problems import build_geometry as jax_geometry
from mmadmm_tpu.problems import build_problem as jax_build_problem

from mmadmm_tpu_torch import ExperimentConfig, build_problem, convert
from mmadmm_tpu_torch.integrators.backward_euler import BackwardEulerIntegrator

STEPS = 4
BASE = dict(dt=5e-3, tau=0.1, rho=50.0)
CASES = {
    "square3d": dict(test_type="SquareGrid", dim=3, mon_type=1, nx=4, ny=4, nz=4),
    "shoulder3d": dict(test_type="Shoulder", dim=3, mon_type=0, nx=4, ny=4, nz=4),
    "compsquare3d": dict(test_type="SquareGrid", dim=3, mon_type=5, nx=4, ny=4, nz=4,
                         comp_mesh=True, rho=10.0),
    "square2d_8": dict(test_type="SquareGrid", dim=2, mon_type=1, nx=8, ny=8),
    "square2d_20": dict(test_type="SquareGrid", dim=2, mon_type=1, nx=20, ny=20),
    "compsquare2d": dict(test_type="SquareGrid", dim=2, mon_type=5, nx=8, ny=8,
                         comp_mesh=True, rho=10.0),
    # 2D SquareGrid nx=8 through the JAX package's writers (write_fromfile)
    "fromfile": dict(test_type="FromFile", dim=2, mon_type=5, triangles_file="tri.txt",
                     pnts_file="pnts.txt", mask_file="mask.txt"),
    # the LevelSet circle of tests/test_harness.py:161-164
    "levelset": dict(name="circle", test_type="LevelSet", dim=2, mon_type=0, nx=12, ny=12,
                     dt=1e-4),
}


def write_fromfile(base: str) -> None:
    X, F, mask, _ = jax_geometry(JaxConfig(test_type="SquareGrid", dim=2, nx=8, ny=8))
    jax_io.write_triangles(os.path.join(base, "tri.txt"), F)
    jax_io.write_points(os.path.join(base, "pnts.txt"), X)
    jax_io.write_mask(os.path.join(base, "mask.txt"), mask)


def config(case: str, method: int, dtype: str, base_dir: str | None = None) -> dict:
    kw = dict(BASE, **CASES[case], method=method, dtype=dtype)
    if kw["test_type"] == "FromFile":
        kw["base_dir"] = base_dir
    return kw


@contextlib.contextmanager
def env(values: dict):
    """Set environment variables for the JAX package's switches, then
    restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def jax_run(kw: dict, steps: int, options: dict | None = None, environ: dict | None = None,
            stencil: bool = False):
    """The JAX package's method ``kw["method"]`` over ``steps`` steps:
    ``(integrator, start state, [(ih, n_newton or None, x, state)])``.
    It is built under the environment ``environ``, its backward Euler
    rebuilt with the constructor arguments ``options``; it must take its
    stencil engine exactly if ``stencil``."""
    with env(environ or {}):
        jmesh, jinteg = jax_build_problem(JaxConfig(**kw))
        if options:
            jinteg = JaxBE(jmesh, kw["dt"], tol=jinteg.tol, **options)
    assert (jinteg._grid2d is not None) == stencil, "the JAX package took another engine"
    s0 = s = jinteg.init_state()
    out = []
    for _ in range(steps):
        if kw["method"] == 1:
            s, ih = jinteg.step(s)
            n = None
        else:  # the jitted step also returns the Newton count
            ns, ih, n = jinteg._step_jit(tuple(s), *jinteg._args)
            s, ih, n = type(s)(*ns), float(ih), int(n)
        out.append((float(ih), n, np.asarray(s.x), s))
    return jinteg, s0, out


def port_run(kw: dict, start, steps: int, options: dict | None = None, chord: bool = False):
    """The port from the JAX start state ``start``: ``(integrator,
    [(info, state)])``. ``options`` rebuild its backward Euler with those
    constructor arguments; ``chord`` loads the whole JAX
    ``BackwardEulerState`` (``convert.load_be_state``)."""
    mesh, integ = build_problem(ExperimentConfig(**kw), device="cpu")
    if options:
        integ = BackwardEulerIntegrator(mesh, kw["dt"], tol=integ.tol, **options)
    if chord:
        state = convert.load_be_state(integ, {k: np.asarray(v)
                                              for k, v in start._asdict().items()})
    else:
        state = convert.load_euler_state(integ, dict(x=np.asarray(start.x)))
    out = []
    for _ in range(steps):
        state, info = integ.step(state)
        out.append((info, state))
    return integ, out


@contextlib.contextmanager
def one_thread():
    """PyTorch on one CPU thread: the meshes here are a few hundred
    elements, and threads only add overhead (about tenfold for the
    forward-derivative Hessians) under the test run's several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
