"""Tensor ops of the PyTorch port against the JAX package on the same
inputs (made with numpy): the Huang functional, the monitor cell fetch,
the 2D stencil operators, the D / D^T pair and the float64 sums.

Tolerances: a pure data-movement op must be bit-equal; arithmetic in f64
within rtol 1e-12 (ops in the same order, a few ulp apart at most); in f32
within rtol 2e-5 (the band of tests/test_prox_pallas2d.py:53-92), since
XLA and PyTorch may order and fuse f32 operations differently."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.ops import huang as jhuang
from mmadmm_tpu.ops.monitor_grid import _cell_index as jax_cell_index
from mmadmm_tpu.ops.monitor_grid import gather_cell as jax_gather_cell
from mmadmm_tpu.ops.reductions import block_sum_f64, block_sumsq_f64
from mmadmm_tpu.ops.stencil2d import make_stencil_ops as jax_stencil
from mmadmm_tpu.problems import build_problem as jax_build_problem

from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem
from mmadmm_tpu_torch.mesh import MovingMesh
from mmadmm_tpu_torch.monitors import get_monitor
from mmadmm_tpu_torch.problems import build_geometry
from mmadmm_tpu_torch.ops import huang
from mmadmm_tpu_torch.ops.monitor_grid import cell_index, gather_cell
from mmadmm_tpu_torch.ops.reductions import sum_f64, sumsq_f64
from mmadmm_tpu_torch.ops.stencil2d import make_stencil_ops

DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64)}
RTOL = {"float32": 2e-5, "float64": 1e-12}


@pytest.fixture(scope="module", params=[(t, d) for t in ("SquareGrid", "Shoulder")
                                        for d in ("float32", "float64")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def meshes(request):
    tt, dt = request.param
    kw = dict(test_type=tt, dim=2, mon_type=1, method=0, nx=16, ny=16, dt=5e-3,
              tau=0.1, rho=50.0, dtype=dt)
    jmesh, _ = jax_build_problem(JaxConfig(**kw))
    X, F, mask = build_geometry(ExperimentConfig(**kw))
    mesh = MovingMesh(X, F, mask, get_monitor(2, 1), rho=50.0, tau=0.1,
                      dtype=DTYPES[dt][1], device="cpu")
    rng = np.random.default_rng(7)
    x = mesh._X_np + rng.normal(scale=2e-3, size=mesh._X_np.shape)
    return dt, jmesh, mesh, x.astype(DTYPES[dt][0])


def test_element_energy(meshes):
    dt, jmesh, mesh, x = meshes
    z = x[mesh._F_np]
    ref = jax.vmap(lambda zz, cc: jhuang.element_energy(zz, None, None, jmesh.ehat, False, cells=cc))(
        jnp.asarray(z), jax.vmap(jax.vmap(jax_gather_cell, in_axes=(None, 0)), in_axes=(None, 0))(
            jmesh.grid, jnp.asarray(z)))
    zt = torch.tensor(z)
    got = huang.element_energy(zt, gather_cell(mesh.grid, zt), mesh.ehat)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL[dt], atol=0)


def test_element_energy_grad(meshes):
    dt, jmesh, mesh, x = meshes
    z = x[mesh._F_np]
    dxpu = (z + np.random.default_rng(3).normal(scale=1e-3, size=z.shape)).astype(z.dtype)
    jcells = jax.vmap(jax.vmap(jax_gather_cell, in_axes=(None, 0)), in_axes=(None, 0))(
        jmesh.grid, jnp.asarray(z))
    ih_r, g_r = jax.vmap(lambda zz, cc, dd: jhuang.element_energy_grad(
        zz, None, None, jmesh.ehat, False, dxpu=dd, w=jmesh.w, cells=cc))(
        jnp.asarray(z), jcells, jnp.asarray(dxpu))
    zt = torch.tensor(z)
    ih, g = huang.element_energy_grad(zt, gather_cell(mesh.grid, zt), mesh.ehat,
                                      torch.tensor(dxpu), mesh.w)
    np.testing.assert_allclose(ih.numpy(), np.asarray(ih_r), rtol=RTOL[dt], atol=0)
    # gradient entries cancel to near zero: scale the absolute band by the largest
    g_r = np.asarray(g_r)
    np.testing.assert_allclose(g.numpy(), g_r, rtol=RTOL[dt], atol=RTOL[dt] * np.abs(g_r).max())


def test_mesh_energy_and_gradient(meshes):
    dt, jmesh, mesh, x = meshes
    e_ref = float(jmesh.energy(jnp.asarray(x)))
    ih_ref, g_ref = jmesh.gradient(jnp.asarray(x), False)
    xt = torch.tensor(x)
    assert float(mesh.energy(xt)) == pytest.approx(e_ref, rel=max(RTOL[dt], 1e-7) / 10)
    ih, g = mesh.gradient(xt)  # the predictor's variant (interior_only=False)
    assert float(ih) == pytest.approx(float(ih_ref), rel=max(RTOL[dt], 1e-7) / 10)
    g_ref = np.asarray(g_ref)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=RTOL[dt], atol=RTOL[dt] * np.abs(g_ref).max())


def test_cell_fetch_bit_equal(meshes):
    """Cell indices (with the uint-clamp quirk for points a whole cell or
    more below the grid) and the fetched cells."""
    dt, jmesh, mesh, x = meshes
    pts = x.copy()
    pts[:5] -= 0.5  # below the grid: the last cell
    pts[5:10] += 0.5  # above: clamped to the last cell
    for d in range(2):
        ref = np.asarray(jax_cell_index(jnp.asarray(pts[:, d]), jmesh.grid.axes[d]))
        got = cell_index(torch.tensor(pts[:, d]), mesh.grid.axes[d]).numpy()
        np.testing.assert_array_equal(got, ref)
    ref = jax.vmap(jax_gather_cell, in_axes=(None, 0))(jmesh.grid, jnp.asarray(pts))
    got = gather_cell(mesh.grid, torch.tensor(pts))
    for k in ("vals", "x0", "x1", "y0", "y1"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_gather_and_scatter(meshes):
    dt, jmesh, mesh, x = meshes
    np.testing.assert_array_equal(mesh.gather(torch.tensor(x)).numpy(),
                                  np.asarray(jmesh.gather(jnp.asarray(x))))
    y = np.random.default_rng(5).normal(size=(mesh.n_elements, 3, 2)).astype(x.dtype)
    np.testing.assert_allclose(mesh.scatter_add(torch.tensor(y)).numpy(),
                               np.asarray(jmesh.scatter_add(jnp.asarray(y))),
                               rtol=RTOL[dt], atol=RTOL[dt])


@pytest.mark.parametrize("test_type", ["SquareGrid", "Shoulder"])
@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_stencil_ops(test_type, dt):
    """gather_ch bit-equal; scatter_ch equal up to summation order."""
    npdt, tdt = DTYPES[dt]
    mesh, integ = build_problem(ExperimentConfig(
        test_type=test_type, dim=2, mon_type=1, nx=16, ny=16, dtype="float32"), device="cpu")
    rng = np.random.default_rng(11)
    x = (mesh._X_np + rng.normal(scale=1e-3, size=mesh._X_np.shape)).astype(npdt)
    y = rng.normal(size=(6, integ.NFd)).astype(npdt)
    swap, alive = integ.swap_k.numpy().astype(npdt), integ.alive_k.numpy().astype(npdt)
    jg, js = jax_stencil(16, 16)
    g, s = make_stencil_ops(16, 16)
    np.testing.assert_array_equal(
        g(torch.tensor(x), torch.tensor(swap)).numpy(),
        np.asarray(jg(jnp.asarray(x), jnp.asarray(swap))))
    np.testing.assert_allclose(
        s(torch.tensor(y), torch.tensor(swap), torch.tensor(alive)).numpy(),
        np.asarray(js(jnp.asarray(y), jnp.asarray(swap), jnp.asarray(alive))),
        rtol=RTOL[dt], atol=RTOL[dt])


@pytest.mark.parametrize("n", [1, 511, 4096, 100_003])
def test_f64_sums(n):
    """The plain f64 sum against the JAX package's blocked sum: f32 blocks
    of 512 carry about 1e-7 relative error, which bounds the difference."""
    a = np.random.default_rng(n).uniform(0.5, 1.5, size=n).astype(np.float32)
    assert float(sum_f64(torch.tensor(a))) == pytest.approx(
        float(block_sum_f64(jnp.asarray(a))), rel=1e-6)
    assert float(sumsq_f64(torch.tensor(a))) == pytest.approx(
        float(block_sumsq_f64(jnp.asarray(a))), rel=1e-6)


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("n", [768, 409_600])
def test_reference_ehat_bit_equal(n, D):
    np.testing.assert_array_equal(huang.reference_ehat(D, n), np.asarray(jhuang.reference_ehat(D, n)))
