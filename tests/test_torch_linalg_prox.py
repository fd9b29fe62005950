"""The generic prox route's pieces against the JAX package:
``mmadmm_tpu_torch/ops/linalg.py::ldlt_solve`` against
``mmadmm_tpu/ops/linalg.py::ldlt_solve``, and one call of the generic
prox (``ops/prox.py::make_prox_solver``) against the JAX package's
``make_prox_solver``, on the same inputs (made with NumPy from a seed).

Bands:

* ``ldlt_solve``: float64 within rtol 1e-13 (the same operations in the
  same order; XLA and PyTorch may still round a few of them differently),
  float32 within rtol 1e-5 of the solution's largest entry (a well
  conditioned SPD batch).
* one prox call in float64: ``z'`` within rtol 1e-10, ``ih0`` within rtol
  1e-12, the returned chord Jacobians within rtol 1e-10 of the largest
  entry of each; in float32 the bands of tests/test_prox_pallas2d.py:
  109-119 (``ih0`` within rtol 2e-5, the regularized energies after the
  solve within rtol 5e-5).
* ``jac_batch``: bit-equal to the whole batch, as the JAX package's
  tests/test_jcarry.py:46 asks of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.ops.linalg import ldlt_solve as jax_ldlt_solve
from mmadmm_tpu.problems import build_problem as jax_build_problem

from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem
from mmadmm_tpu_torch.ops.linalg import ldlt_solve
from mmadmm_tpu_torch.ops.prox import make_prox_solver

DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64)}


def _spd(rng, nb, n, tiny_pivots=False):
    """A batch of SPD matrices ``[nb, n, n]``; with ``tiny_pivots`` some
    rows and columns are scaled so that LDL^T meets pivots under 1e-12
    (and one matrix is singular)."""
    a = rng.normal(size=(nb, n, n))
    A = a @ np.swapaxes(a, 1, 2) + n * np.eye(n)
    if tiny_pivots:
        s = np.ones((nb, n))
        s[:, n // 2] = 1e-7
        s[0, 1] = 0.0
        A = A * s[:, :, None] * s[:, None, :]
    return A


@pytest.mark.parametrize("tiny_pivots", [False, True], ids=["spd", "tiny_pivots"])
@pytest.mark.parametrize("n", [6, 12])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ldlt_solve_matches_jax(dtype, n, tiny_pivots):
    npt, tt = DTYPES[dtype]
    rng = np.random.default_rng(n + 100 * tiny_pivots)
    A = _spd(rng, 64, n, tiny_pivots).astype(npt)
    b = rng.normal(size=(64, n)).astype(npt)
    x = ldlt_solve(torch.tensor(A, dtype=tt), torch.tensor(b, dtype=tt)).numpy()
    xj = np.asarray(jax.vmap(jax_ldlt_solve)(jnp.asarray(A), jnp.asarray(b)))
    assert x.dtype == xj.dtype == npt
    assert np.array_equal(np.isfinite(x), np.isfinite(xj))
    if dtype == "float64":
        np.testing.assert_allclose(x, xj, rtol=1e-13, atol=0)
    else:
        np.testing.assert_allclose(x, xj, rtol=0, atol=1e-5 * np.abs(xj).max())
    if tiny_pivots:  # the clamp was reached: pivots under 1e-12 became 1e-12
        assert np.isfinite(x).all() and np.abs(x).max() > 1e6


def test_ldlt_solve_reads_the_lower_triangle_only():
    rng = np.random.default_rng(7)
    A = torch.tensor(_spd(rng, 8, 12))
    b = torch.tensor(rng.normal(size=(8, 12)))
    junk = A + torch.triu(torch.tensor(rng.normal(size=(8, 12, 12))), diagonal=1)
    assert torch.equal(ldlt_solve(A, b), ldlt_solve(junk, b))


CASES = {
    "square2d": dict(test_type="SquareGrid", dim=2, mon_type=1, nx=8, ny=8, rho=50.0),
    "compsquare3d": dict(test_type="SquareGrid", dim=3, mon_type=5, nx=4, ny=4, nz=4,
                         rho=10.0, comp_mesh=True),
}


@pytest.fixture(scope="module")
def pair():
    """``(JAX mesh, port mesh, z, dxpu, dxpu2)`` per case and dtype: both on
    the generic route, the inputs the initial element blocks plus seeded
    normal noise (``dxpu2`` for a second, carried call)."""
    cache = {}

    def get(case, dtype):
        if (case, dtype) not in cache:
            kw = dict(CASES[case], method=0, dt=5e-3, tau=0.1, dtype=dtype, prox_backend="vmap")
            jmesh, _ = jax_build_problem(JaxConfig(**kw))
            mesh, _ = build_problem(ExperimentConfig(**kw), device="cpu")
            assert jmesh.prox_backend == mesh.prox_backend == "vmap"
            npt = DTYPES[dtype][0]
            z = np.asarray(jmesh.gather(jmesh.X0)).astype(npt)
            rng = np.random.default_rng(11)
            dxpu = (z + rng.normal(scale=1e-3, size=z.shape)).astype(npt)
            dxpu2 = (z + rng.normal(scale=1e-3, size=z.shape)).astype(npt)
            cache[case, dtype] = (jmesh, mesh, z, dxpu, dxpu2)
        return cache[case, dtype]

    return get


def _calls(jmesh, mesh, z, dxpu, dxpu2):
    """A fresh call and a carried one on each side: ``[(jax_out, port_out)]``,
    each ``(z', ih0, J)`` as NumPy."""
    nf, n = z.shape[0], z.shape[1] * z.shape[2]
    zero = np.zeros((nf, n, n), dtype=z.dtype)
    args_j = (jmesh.grid, jnp.asarray(z), jmesh.xi)
    args_p = (mesh.grid, torch.tensor(z), mesh.xi)
    tail = (1e-5, 50)
    j1 = jmesh.prox_fn(*args_j, jnp.asarray(dxpu), jmesh.elem_free, *tail,
                       (jnp.asarray(zero), jnp.asarray(True)))
    p1 = mesh.prox_fn(*args_p, torch.tensor(dxpu), mesh.elem_free, *tail,
                      (torch.tensor(zero), True))
    # the carried call starts both sides from the JAX package's z', each
    # with its own carried J
    z1 = np.asarray(j1[0])
    j2 = jmesh.prox_fn(jmesh.grid, jnp.asarray(z1), jmesh.xi, jnp.asarray(dxpu2),
                       jmesh.elem_free, *tail, (j1[2], jnp.asarray(False)))
    p2 = mesh.prox_fn(mesh.grid, torch.tensor(z1), mesh.xi, torch.tensor(dxpu2), mesh.elem_free,
                      *tail, (p1[2], False))
    return [(tuple(np.asarray(a) for a in j), tuple(a.numpy() for a in p))
            for j, p in ((j1, p1), (j2, p2))]


@pytest.mark.parametrize("case", list(CASES))
def test_one_prox_call_matches_jax_float64(pair, case):
    jmesh, mesh, z, dxpu, dxpu2 = pair(case, "float64")
    for (zj, ihj, Jj), (zp, ihp, Jp) in _calls(jmesh, mesh, z, dxpu, dxpu2):
        np.testing.assert_allclose(zp, zj, rtol=1e-10, atol=0)
        np.testing.assert_allclose(ihp, ihj, rtol=1e-12, atol=0)
        scale = np.abs(Jj).max((1, 2), keepdims=True)
        np.testing.assert_allclose(Jp / scale, Jj / scale, rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", list(CASES))
def test_one_prox_call_matches_jax_float32(pair, case):
    jmesh, mesh, z, dxpu, dxpu2 = pair(case, "float32")
    calls = _calls(jmesh, mesh, z, dxpu, dxpu2)
    for ((zj, ihj, _), (zp, ihp, _)), d in zip(calls, (dxpu, dxpu2)):
        np.testing.assert_allclose(ihp, ihj, rtol=2e-5, atol=1e-8)

        def reg_energy(zz):
            e = np.asarray(jmesh._energy_e(jnp.asarray(zz), jmesh.xi, jmesh.grid))
            return e + 0.5 * mesh.w ** 2 * np.sum((d - zz) ** 2, axis=(1, 2))

        np.testing.assert_allclose(reg_energy(zp), reg_energy(zj), rtol=5e-5, atol=1e-7)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_jac_batch_streams_same_values(pair, case, dtype):
    """The slab-streamed Jacobian builds give the whole batch's values,
    bit for bit, on a fresh call and a carried one (JAX
    tests/test_jcarry.py:46)."""
    _, mesh, z, dxpu, _ = pair(case, dtype)
    dim, nf = mesh.dim, z.shape[0]
    n = dim * (dim + 1)
    args = (mesh.grid, torch.tensor(z), mesh.xi, torch.tensor(dxpu), mesh.elem_free, 1e-5, 3)
    outs = []
    for jb in (None, 40):  # 40 divides neither 128 nor 768: a short last slab
        prox = make_prox_solver(mesh.ehat, mesh.comp_mesh, mesh.w, dim, jac_batch=jb)
        fresh = prox(*args, (torch.zeros((nf, n, n), dtype=mesh.dtype), True))
        outs.append(fresh + prox(*args, (fresh[2], False)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_default_slab_rule():
    """``jac_batch`` follows the JAX package's rule (mesh.py:157-166):
    slabs of 131,072 for 3D meshes over 300,000 elements, else the whole
    batch; a given size overrides it, 0 asks for the whole batch."""
    small = dict(test_type="SquareGrid", method=0, rho=50.0)
    for kw, jb, want in ((dict(dim=2, nx=4, ny=4), None, None),
                         (dict(dim=2, nx=4, ny=4), 64, 64),
                         (dict(dim=3, nx=30, ny=30, nz=30), None, 131_072),
                         (dict(dim=3, nx=30, ny=30, nz=30), 0, None)):
        from mmadmm_tpu_torch.mesh import MovingMesh
        from mmadmm_tpu_torch.monitors import get_monitor
        from mmadmm_tpu_torch.problems import build_geometry

        X, F, mask = build_geometry(ExperimentConfig(**small, **kw))
        mesh = MovingMesh(X, F, mask, get_monitor(kw["dim"], 0), rho=50.0, tau=0.1,
                          device="cpu", jac_batch=jb)
        assert mesh.prox_backend == "vmap" and mesh.jac_batch == want, (kw, jb)
