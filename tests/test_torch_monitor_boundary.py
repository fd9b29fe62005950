"""The rest of ROADMAP A16 against the JAX package: the monitor grids of a
monitor that is not symmetric (the 20-wide 2D table and the narrow 3D
path), a step on the generic route on each, and the free-slip boundary
projector.

* Grids for ``test_torch_setup._skewed`` (``M[0, 1] = 0.5 + x``): the
  2D table and the 3D grid values bit-equal to the JAX package's, and
  ``gather_cell`` and ``sample_monitor`` bit-equal on points inside and
  outside the grid.
* One MM-ADMM step on each (2D SquareGrid nx=8, 3D nx=2, float64; both
  packages take the stock engine on the generic prox): ``I_h`` and x
  within rel 1e-10. The kernels never take these grids.
* ``project_onto_boundary`` against ``mmadmm_tpu/ops/boundary.py`` on the
  cases of ``tests/test_geometry.py`` (a 4x4 2D and a 3x3x3 3D box of
  BOUNDARY_FREE nodes), and on every free node pulled off at random:
  within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmadmm_tpu.problems as jax_problems
from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.geometry.rect_mesh import generate_uniform_rect_mesh as jax_rect
from mmadmm_tpu.geometry.topology import build_boundary_faces as jax_faces
from mmadmm_tpu.ops.boundary import make_boundary_projector as jax_projector
from mmadmm_tpu.ops.monitor_grid import build_monitor_grid as jax_grid
from mmadmm_tpu.ops.monitor_grid import gather_cell as jax_gather_cell
from mmadmm_tpu.ops.monitor_grid import sample_monitor as jax_sample

from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem, problems
from mmadmm_tpu_torch.geometry.node_type import NodeType
from mmadmm_tpu_torch.geometry.rect_mesh import generate_uniform_rect_mesh
from mmadmm_tpu_torch.geometry.topology import build_boundary_faces
from mmadmm_tpu_torch.ops.boundary import make_boundary_projector
from mmadmm_tpu_torch.ops.monitor_grid import build_monitor_grid, gather_cell, sample_monitor
from test_torch_setup import _skewed

KW = dict(test_type="SquareGrid", mon_type=1, method=0, dt=5e-3, tau=0.1, rho=50.0,
          dtype="float64")


def _box(dim, nx, btype=NodeType.BOUNDARY_FIXED):
    return generate_uniform_rect_mesh(dim, nx, nx, nx if dim == 3 else 0, 0.0, 1.0, 0.0, 1.0,
                                      0.0, 1.0, btype)


@pytest.mark.parametrize("dim,nx", [(2, 8), (3, 4)])
def test_skewed_grid_equals_the_jax_package(dim, nx):
    X, _, _ = _box(dim, nx)
    ours = build_monitor_grid(X, _skewed, dtype=torch.float64, device="cpu")
    theirs = jax_grid(X, _skewed, dtype=jnp.float64)
    assert not ours.kernel_table and not ours.constant
    if dim == 2:
        assert ours.cell_table.shape[-1] == 20
        np.testing.assert_array_equal(ours.cell_table.numpy(), np.asarray(theirs.cell_table))
    else:
        assert ours.cell_table is None and theirs.cell_table is None
        np.testing.assert_array_equal(ours.values.numpy(), np.asarray(theirs.values))
    pts = np.random.default_rng(0).uniform(-0.2, 1.2, (64, dim))
    cells = gather_cell(ours, torch.as_tensor(pts))
    jcells = jax.vmap(lambda p: jax_gather_cell(theirs, p))(jnp.asarray(pts))
    assert set(cells) == set(jcells)
    for k in cells:
        np.testing.assert_array_equal(cells[k].numpy(), np.asarray(jcells[k]), err_msg=k)
    np.testing.assert_array_equal(
        sample_monitor(ours, torch.as_tensor(pts)).numpy(),
        np.asarray(jax.vmap(lambda p: jax_sample(theirs, p))(jnp.asarray(pts))))


@pytest.mark.parametrize("dim,nx", [(2, 8), (3, 2)])
def test_skewed_monitor_step_matches_the_jax_package(dim, nx, monkeypatch):
    monkeypatch.setattr(problems, "get_monitor", lambda d, t: _skewed)
    monkeypatch.setattr(jax_problems, "get_monitor", lambda d, t: _skewed)
    kw = dict(KW, dim=dim, nx=nx, ny=nx, nz=nx if dim == 3 else 0)
    mesh, integ = build_problem(ExperimentConfig(**kw), "cpu")
    assert type(integ).__name__ == "ADMMIntegrator" and mesh.prox_backend == "vmap"
    _, jinteg = jax_problems.build_problem(JaxConfig(**kw))
    assert type(jinteg).__name__ == "ADMMIntegrator"
    state, info = integ.step(integ.init_state())
    jstate, jinfo = jinteg.step(jinteg.init_state())
    assert info.n_iters == int(jinfo.n_iters)
    np.testing.assert_allclose(info.ih, float(jinfo.ih_start), rtol=1e-10)
    np.testing.assert_allclose(state.x.numpy(), np.asarray(jstate.x), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("change", [dict(method=1), dict(method=2), dict(dtype="float32")],
                         ids=["euler", "be", "float32"])
def test_skewed_monitor_keeps_off_the_kernels(change, monkeypatch):
    """Float32 takes the generic prox, methods 1 and 2 the compact path;
    asking for the kernels raises."""
    monkeypatch.setattr(problems, "get_monitor", lambda d, t: _skewed)
    kw = dict(KW, dim=2, nx=16, ny=16, test_type="Shoulder", **change)
    mesh, integ = build_problem(ExperimentConfig(**kw), "cpu")
    if kw["method"] == 0:
        assert type(integ).__name__ == "ADMMIntegrator" and mesh.prox_backend == "vmap"
    else:
        assert type(integ.eg).__name__ == "CompactEG"
    state, info = integ.step(integ.init_state())
    assert np.isfinite(info.ih) and bool(torch.isfinite(state.x).all())
    with pytest.raises(ValueError, match="symmetric cell table"):
        build_problem(ExperimentConfig(**dict(kw, prox_backend="pallas")), "cpu")


def _projectors(dim, nx):
    X, F, mask = _box(dim, nx, NodeType.BOUNDARY_FREE)
    JX, JF, jmask = jax_rect(dim, nx, nx, nx if dim == 3 else 0, 0.0, 1.0, 0.0, 1.0, 0.0, 1.0,
                             boundary_type=NodeType.BOUNDARY_FREE)
    np.testing.assert_array_equal(X, JX)
    faces = build_boundary_faces(F, mask)
    np.testing.assert_array_equal(faces, jax_faces(JF, jmask))
    return X, F, mask, make_boundary_projector(faces, mask, dim), jax_projector(faces, mask, dim)


def _both(proj, jproj, x, ref):
    ours = proj(torch.as_tensor(x), torch.as_tensor(ref)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jproj(jnp.asarray(x), jnp.asarray(ref))),
                               rtol=0, atol=1e-12)
    return ours


def test_projector_2d_matches_the_jax_package():
    X, _, mask, proj, jproj = _projectors(2, 4)
    free = np.nonzero((mask == NodeType.BOUNDARY_FREE) & (X[:, 1] == 0.0)
                      & (X[:, 0] > 0.0) & (X[:, 0] < 1.0))[0]
    n = int(free[0])
    x = X.copy()
    x[n, 1] += 0.07
    out = _both(proj, jproj, x, X)
    assert out[n, 1] == 0.0 and out[n, 0] == X[n, 0]
    x = X + np.random.default_rng(1).normal(scale=0.05, size=X.shape)
    out = _both(proj, jproj, x, X)
    moved = mask == NodeType.BOUNDARY_FREE
    np.testing.assert_array_equal(out[~moved], x[~moved])


def test_projector_3d_matches_the_jax_package():
    X, _, mask, proj, jproj = _projectors(3, 3)
    faces = build_boundary_faces(_box(3, 3, NodeType.BOUNDARY_FREE)[1], mask)
    free = np.nonzero((mask == NodeType.BOUNDARY_FREE) & (X[:, 2] == 0.0)
                      & (X[:, 0] > 0.0) & (X[:, 0] < 1.0) & (X[:, 1] > 0.0) & (X[:, 1] < 1.0))[0]
    n = int(free[0])
    x = X.copy()
    x[n, 2] += 0.05  # projects onto a vertex, which CHECK_EPS rejects: no move
    np.testing.assert_array_equal(_both(proj, jproj, x, X), x)
    target = X[[f for f in faces if n in f and np.all(X[f][:, 2] == 0.0)][0]].mean(axis=0)
    x = X.copy()
    x[n] = target + np.array([0.0, 0.0, 0.05])
    np.testing.assert_allclose(_both(proj, jproj, x, X)[n], target, atol=1e-12)
    _both(proj, jproj, X + np.random.default_rng(2).normal(scale=0.05, size=X.shape), X)


def test_project_onto_boundary_on_the_mesh():
    """``MovingMesh.project_onto_boundary``: the identity on an all-fixed
    mesh; on a free one, the JAX mesh's projection (both meshes take their
    faces from the reoriented elements)."""
    mesh, _ = build_problem(ExperimentConfig(**dict(KW, dim=2, nx=4, ny=4)), "cpu")
    np.testing.assert_array_equal(mesh.project_onto_boundary(mesh.X0).numpy(), mesh.X0.numpy())
    kw = dict(KW, dim=3, nx=3, ny=3, nz=3, boundary_type=0)
    mesh, _ = build_problem(ExperimentConfig(**kw), "cpu")
    jmesh, _ = jax_problems.build_problem(JaxConfig(**kw))
    X = mesh.X0.numpy()
    x = X + np.random.default_rng(3).normal(scale=0.05, size=X.shape)
    ours = mesh.project_onto_boundary(torch.as_tensor(x), mesh.X0).numpy()
    theirs = np.asarray(jmesh.project_onto_boundary(jnp.asarray(x), jnp.asarray(X)))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)
    assert not np.array_equal(ours, x)
