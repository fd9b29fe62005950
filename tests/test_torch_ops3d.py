"""Host set-up and tensor ops of the 3D slice against the JAX package on the
same inputs (made with numpy), at 3D SquareGrid nx=4 with the identity
(constant grid) and radial-bump (48-wide table) monitors, and at 3D
Shoulder nx=4 (672 live tets of 768) with the identity monitor.

Tolerances: set-up arrays and pure data movement bit-equal; f32 sums of
the stencil scatter within rtol 2e-5; the Huang functional at the bands
of tests/test_prox_pallas3d.py:64-87 (Ih rtol 2e-5; gradient rtol 3e-4,
atol 3e-5 of its largest entry), since XLA and PyTorch may order and fuse
f32 operations differently."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.integrators.admm_soa import SoAADMM3D as JaxSoA
from mmadmm_tpu.mesh import MovingMesh as JaxMesh
from mmadmm_tpu.monitors import get_monitor as jax_monitor
from mmadmm_tpu.ops import huang as jhuang
from mmadmm_tpu.ops.monitor_grid import _cell_index as jax_cell_index
from mmadmm_tpu.ops.monitor_grid import gather_cell as jax_gather_cell
from mmadmm_tpu.ops.stencil3d import make_stencil_ops_3d as jax_stencil3d
from mmadmm_tpu.ops.stencil3d import match_dense_3d as jax_match_dense_3d
from mmadmm_tpu.problems import build_geometry as jax_geometry
from mmadmm_tpu.runtime.native import grid_nn_map as jax_nn_map

from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem
from mmadmm_tpu_torch.ops import huang
from mmadmm_tpu_torch.ops.monitor_grid import SYM3, cell_index, cell_rows216, gather_cell
from mmadmm_tpu_torch.ops.stencil3d import make_stencil_ops_3d, match_dense_3d
from mmadmm_tpu_torch.problems import build_geometry
from mmadmm_tpu_torch.runtime.nn import grid_nn_map

CONFIGS = [("SquareGrid", 0), ("SquareGrid", 1), ("Shoulder", 0)]


def _kw(test_type, mon_type):
    return dict(test_type=test_type, dim=3, mon_type=mon_type, method=0, nx=4, ny=4, nz=4,
                dt=5e-3, tau=0.1, rho=50.0, dtype="float32")


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda p: f"{p[0]}-mon{p[1]}")
def both(request):
    """(kw, the JAX MovingMesh, the port's (mesh, integrator), perturbed
    node positions [NP, 3] f32)."""
    kw = _kw(*request.param)
    X, F, mask, _ = jax_geometry(JaxConfig(**kw))
    jmesh = JaxMesh(X, F, mask, jax_monitor(3, kw["mon_type"]), rho=50.0, tau=0.1,
                    dtype=np.float32)
    mesh, integ = build_problem(ExperimentConfig(**kw), device="cpu")
    rng = np.random.default_rng(7)
    x = (mesh._X_np + rng.normal(scale=2e-3, size=mesh._X_np.shape)).astype(np.float32)
    return kw, jmesh, mesh, integ, x


def _jax_cells216(jgrid, z):
    """The JAX SoA engine's cell channels ``[216, NF]`` for ``z [NF, 4, 3]``
    (``admm_soa.py:642-665``)."""
    ax, ay, az = jgrid.axes
    n = ax.shape[0] - 1
    parts = []
    for v in range(4):
        xi, yi, zi = (jax_cell_index(jnp.asarray(z[:, v, d]), a) for d, a in enumerate((ax, ay, az)))
        if jgrid.constant:
            sym = jgrid.values.reshape(-1, 9)[0][jnp.asarray(SYM3)]
            vals = jnp.broadcast_to(jnp.tile(sym, 8)[:, None], (48, z.shape[0]))
        else:
            vals = jgrid.cell_table[(zi * n + yi) * n + xi].T
        parts += [vals, jnp.stack([ax[xi], ax[xi + 1], ay[yi], ay[yi + 1], az[zi], az[zi + 1]])]
    return np.asarray(jnp.concatenate(parts))


def test_geometry_and_mesh_bit_equal(both):
    kw, jmesh, mesh, _, _ = both
    X, F, mask = build_geometry(ExperimentConfig(**kw))
    Xj, Fj, maskj, _ = jax_geometry(JaxConfig(**kw))
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(F, Fj)
    np.testing.assert_array_equal(mask, maskj)
    np.testing.assert_array_equal(mesh._F_np, jmesh._F_np)
    np.testing.assert_array_equal(mesh.elem_free.numpy(), np.asarray(jmesh.elem_free))
    np.testing.assert_array_equal(mesh.ehat.numpy(), np.asarray(jmesh.ehat))
    np.testing.assert_array_equal(mesh.X0.numpy(), np.asarray(jmesh.X0))
    assert mesh.w == jmesh.w and mesh.dim == 3


def test_nn_map_matches_native(both):
    """The port's map (cKDTree and the native tie rule) and the JAX
    package's native grid hash agree, ties included."""
    _, _, mesh, _, _ = both
    X = mesh._X_np
    lo, hi = X.min(0), X.max(0)
    n = int((X.shape[0] * 3) ** (1.0 / 3))
    np.testing.assert_array_equal(grid_nn_map(X, lo, hi, n), jax_nn_map(X, lo, hi, n))


def test_monitor_grid_bit_equal(both):
    _, jmesh, mesh, _, _ = both
    grid, jgrid = mesh.grid, jmesh.grid
    for a, b in zip(grid.axes, jgrid.axes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert grid.constant == bool(jgrid.constant)
    if grid.constant:
        np.testing.assert_array_equal(grid.sym6.numpy(),
                                      np.asarray(jgrid.values).reshape(-1, 9)[0][SYM3])
        assert grid.cell_table is None
    else:
        np.testing.assert_array_equal(grid.cell_table.numpy(), np.asarray(jgrid.cell_table))


def test_match_dense_3d_equal(both):
    _, jmesh, mesh, _, _ = both
    for a, b in zip(match_dense_3d(4, 4, 4, mesh._F_np), jax_match_dense_3d(4, 4, 4, jmesh._F_np)):
        np.testing.assert_array_equal(a, b)


def test_match_dense_3d_rejects_other_orders(both):
    _, _, mesh, _, _ = both
    F = mesh._F_np
    with pytest.raises(ValueError):
        match_dense_3d(4, 4, 4, F[::-1])
    with pytest.raises(ValueError):
        match_dense_3d(4, 4, 4, F[:, [1, 0, 2, 3]])


def test_stencil_ops_3d(both):
    """gather_ch bit-equal; scatter_ch equal up to f32 rounding."""
    _, _, mesh, integ, x = both
    NPg = 5 * 5 * 5
    swap, alive = integ.swap_t.numpy(), integ.alive_t.numpy()
    y = np.random.default_rng(11).normal(size=(12, integ.NFd)).astype(np.float32)
    jg, js = jax_stencil3d(4, 4, 4)
    g, s = make_stencil_ops_3d(4, 4, 4)
    xt = x.T.copy()
    ref = np.stack([np.asarray(c) for c in jg(jnp.asarray(xt[:, :NPg]), jnp.asarray(xt[:, NPg:]),
                                               jnp.asarray(swap))])
    np.testing.assert_array_equal(g(torch.tensor(xt), torch.tensor(swap)).numpy(), ref)
    sg, sm = js([jnp.asarray(c) for c in y], jnp.asarray(swap), jnp.asarray(alive))
    np.testing.assert_allclose(
        s(torch.tensor(y), torch.tensor(swap), torch.tensor(alive)).numpy(),
        np.concatenate([np.asarray(sg), np.asarray(sm)], axis=1), rtol=2e-5, atol=2e-5)


def test_stencil_gather_is_the_mesh_gather(both):
    """On live slots the stencil gather is ``x[F]`` of the compact mesh."""
    _, _, mesh, integ, x = both
    alive, _, m_of_d = match_dense_3d(4, 4, 4, mesh._F_np)
    zc = integ.gather(torch.tensor(x.T.copy())).numpy().T.reshape(-1, 4, 3)
    np.testing.assert_array_equal(zc[alive], x[mesh._F_np][m_of_d[alive]])


def test_cell_rows216_bit_equal(both):
    _, jmesh, mesh, integ, x = both
    z = x[mesh._F_np]
    z[:3] -= 0.5  # below the grid: the last cell (the uint-clamp quirk)
    z[3:6] += 0.5  # above: clamped to the last cell
    got = cell_rows216(mesh.grid, torch.tensor(z.reshape(-1, 12).T.copy()))
    np.testing.assert_array_equal(got.numpy(), _jax_cells216(jmesh.grid, z))


def test_gather_cell_3d_bit_equal(both):
    _, jmesh, mesh, _, x = both
    pts = x.copy()
    pts[:5] -= 0.5
    pts[5:10] += 0.5
    for d in range(3):
        ref = np.asarray(jax_cell_index(jnp.asarray(pts[:, d]), jmesh.grid.axes[d]))
        np.testing.assert_array_equal(cell_index(torch.tensor(pts[:, d]), mesh.grid.axes[d]).numpy(), ref)
    ref = jax.vmap(jax_gather_cell, in_axes=(None, 0))(jmesh.grid, jnp.asarray(pts))
    got = gather_cell(mesh.grid, torch.tensor(pts))
    for k in ("vals", "x0", "x1", "y0", "y1", "z0", "z1"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_element_energy_grad_3d(both):
    _, jmesh, mesh, _, x = both
    z = x[mesh._F_np]
    dxpu = (z + np.random.default_rng(3).normal(scale=1e-3, size=z.shape)).astype(np.float32)
    jcells = jax.vmap(jax.vmap(jax_gather_cell, in_axes=(None, 0)), in_axes=(None, 0))(
        jmesh.grid, jnp.asarray(z))
    ih_r, g_r = jax.vmap(lambda zz, cc, dd: jhuang.element_energy_grad(
        zz, None, None, jmesh.ehat, False, dxpu=dd, w=jmesh.w, cells=cc))(
        jnp.asarray(z), jcells, jnp.asarray(dxpu))
    e_r = jax.vmap(lambda zz, cc: jhuang.element_energy(zz, None, None, jmesh.ehat, False,
                                                        cells=cc))(jnp.asarray(z), jcells)
    zt = torch.tensor(z)
    cells = gather_cell(mesh.grid, zt)
    ih, g = huang.element_energy_grad(zt, cells, mesh.ehat, torch.tensor(dxpu), mesh.w)
    np.testing.assert_allclose(ih.numpy(), np.asarray(ih_r), rtol=2e-5, atol=0)
    np.testing.assert_allclose(huang.element_energy(zt, cells, mesh.ehat).numpy(),
                               np.asarray(e_r), rtol=2e-5, atol=0)
    g_r = np.asarray(g_r)
    np.testing.assert_allclose(g.numpy(), g_r, rtol=3e-4, atol=3e-5 * np.abs(g_r).max())


def test_mesh_energy_and_gradient_3d(both):
    _, jmesh, mesh, _, x = both
    e_ref = float(jmesh.energy(jnp.asarray(x)))
    ih_ref, g_ref = jmesh.gradient(jnp.asarray(x), False)
    xt = torch.tensor(x)
    assert float(mesh.energy(xt)) == pytest.approx(e_ref, rel=2e-6)
    ih, g = mesh.gradient(xt)
    assert float(ih) == pytest.approx(float(ih_ref), rel=2e-6)
    g_ref = np.asarray(g_ref)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=3e-4, atol=3e-5 * np.abs(g_ref).max())


def test_predictor_gradient_is_the_compact_one(both):
    """The engine's stencil predictor gradient equals the compact mesh's
    ``eulerGrad`` up to the order of the f32 node sums."""
    _, _, mesh, integ, x = both
    g_st = integ.euler_grad(torch.tensor(x.T.copy())).T.numpy()
    g_c = mesh.gradient(torch.tensor(x))[1].numpy()
    np.testing.assert_allclose(g_st, g_c, rtol=2e-5, atol=2e-5 * np.abs(g_c).max())


def test_soa_constants_bit_equal(both):
    """The engine's masks, per-slot free mask, validity and x-update
    diagonal against the JAX SoAADMM3D's (its ``[C, 12, S]`` chunks are the
    port's ``[12, NFd]`` with a padded tail)."""
    _, jmesh, _, integ, _ = both
    jc = JaxSoA(jmesh, 5e-3, grid_dims=(4, 4, 4))._consts
    np.testing.assert_array_equal(integ.swap_t.numpy(), np.asarray(jc["swap_t"]))
    np.testing.assert_array_equal(integ.alive_t.numpy(), np.asarray(jc["alive_t"]))
    free = np.asarray(jc["free_chunks"]).transpose(1, 0, 2).reshape(12, -1)
    np.testing.assert_array_equal(integ.free.numpy(), free[:, :integ.NFd])
    np.testing.assert_array_equal(integ.valid.numpy(), np.asarray(jc["valid"])[:integ.NFd])
    np.testing.assert_array_equal(integ.t_node.numpy(), np.asarray(jc["t_node"]))
