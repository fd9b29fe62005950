"""The port's NumPy copies of ``mmadmm_tpu/geometry/level_set.py`` and
``refine.py``, and the LevelSet branch of ``build_geometry``: every array
equal to the JAX package's, bit for bit."""

import numpy as np
import pytest

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.geometry import level_set as jax_ls
from mmadmm_tpu.geometry.refine import refine_triangle_mesh as jax_refine
from mmadmm_tpu.problems import build_geometry as jax_geometry

from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig
from mmadmm_tpu_torch.geometry import level_set as ls
from mmadmm_tpu_torch.geometry.node_type import NodeType
from mmadmm_tpu_torch.geometry.refine import refine_triangle_mesh
from mmadmm_tpu_torch.problems import build_geometry

PHIS = ["circle_phi", "sphere_phi", "blood_cell_phi_2d", "blood_cell_phi_3d", "heart_phi",
        "shoulder_phi"]


@pytest.mark.parametrize("name", PHIS)
def test_level_set_functions_bit_equal(name):
    dim = 3 if name in ("sphere_phi", "blood_cell_phi_3d") else 2
    p = np.random.default_rng(3).uniform(0.0, 1.0, size=(257, dim))
    np.testing.assert_array_equal(getattr(ls, name)(p), getattr(jax_ls, name)(p))


@pytest.mark.parametrize("dim,nx,name,normal", [
    (2, 12, "circle_phi", "circle"), (2, 64, "circle_phi", "circle"),
    (2, 16, "circle_phi", "grad"), (3, 6, "sphere_phi", "grad"),
    (2, 20, "heart_phi", "grad"),
])
def test_mesh_from_level_set_bit_equal(dim, nx, name, normal):
    args = (dim, nx, nx, nx if dim == 3 else 0)
    kw = dict(boundary_type=NodeType.BOUNDARY_FIXED, normal=normal)
    if name == "heart_phi":
        kw.update(xa=-1.0, xb=2.0, ya=0.0, yb=3.0)
    a = ls.mesh_from_level_set(getattr(ls, name), *args, **kw)
    b = jax_ls.mesh_from_level_set(getattr(jax_ls, name), *args, **kw)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)
    assert a[1].shape[0] > 0


@pytest.mark.parametrize("dim,nx", [(2, 12), (2, 320), (3, 6)])
def test_build_geometry_levelset_bit_equal(dim, nx):
    """The circle in 2D, the sphere in 3D (``problems.py:49-58`` in the JAX
    package)."""
    kw = dict(test_type="LevelSet", dim=dim, nx=nx, ny=nx, nz=nx if dim == 3 else 0)
    X, F, mask, _ = jax_geometry(JaxConfig(**kw))
    for u, v in zip(build_geometry(ExperimentConfig(**kw)), (X, F, mask)):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("project", [False, True])
@pytest.mark.parametrize("test_type", ["SquareGrid", "LevelSet"])
def test_refine_triangle_mesh_bit_equal(test_type, project):
    kw = dict(test_type=test_type, dim=2, nx=10, ny=10)
    X, F, mask = build_geometry(ExperimentConfig(**kw))
    if project:  # a mesh of the unit circle, as the BaseCircle series
        X = (X - 0.5) / 0.35
    a = refine_triangle_mesh(X, F, mask, project_boundary_to_unit_circle=project)
    b = jax_refine(X, F, mask, project_boundary_to_unit_circle=project)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)
    assert a[1].shape[0] == 4 * F.shape[0]
