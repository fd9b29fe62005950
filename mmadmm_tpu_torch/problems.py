"""Experiment setup: config -> (mesh, integrator) (port of
``mmadmm_tpu/problems.py``; reference ``main.cpp:142-782``).

The port runs MM-ADMM (method 0), explicit Euler (method 1) and backward
Euler (method 2) on the 2D stencil engine, and MM-ADMM on the 3D stencil
engine (the JAX package's ``SoAADMM3D`` in stencil mode). Every other
route raises ``NotImplementedError`` naming the ROADMAP item that ports
it. The JAX package also gates the stencil engines on mesh size (and, for
Euler and backward Euler, on environment switches), to choose between
them and the compact element-major engines; the port has only the stencil
engines, so it takes every mesh that fits them.
"""

from __future__ import annotations

import torch

from .config import ExperimentConfig
from .geometry.node_type import NodeType
from .geometry.rect_mesh import generate_uniform_rect_mesh
from .geometry.shoulder import make_shoulder_mesh
from .mesh import MovingMesh
from .monitors import get_monitor
from .ops.stencil2d import dense_layout
from .ops.stencil3d import dense_layout_3d

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build_geometry(cfg: ExperimentConfig):
    """``(X, F, mask)`` for SquareGrid and Shoulder (``main.cpp:874-904``)."""
    btype = NodeType(cfg.boundary_node_type)
    args = (cfg.dim, cfg.nx, cfg.ny, cfg.nz, cfg.xa, cfg.xb, cfg.ya, cfg.yb,
            cfg.za, cfg.zb, btype)
    if cfg.test_type == "SquareGrid":
        return generate_uniform_rect_mesh(*args)
    if cfg.test_type == "Shoulder":
        return make_shoulder_mesh(*args)
    if cfg.test_type in ("LevelSet", "FromFile"):
        raise NotImplementedError(
            f"{cfg.test_type} meshes run on the compact engines (ROADMAP item A10)"
        )
    raise ValueError(f"unknown TestType {cfg.test_type!r}")


def build_problem(cfg: ExperimentConfig, device=None):
    """Return ``(mesh, integrator)`` ready to run, on ``device`` (CUDA
    unless the caller asks for the CPU)."""
    if cfg.method not in (0, 1, 2):
        raise ValueError(f"unknown method {cfg.method}")
    if cfg.dim == 3 and cfg.method != 0:
        item = "A11" if cfg.method == 1 else "A12"
        raise NotImplementedError(f"3D method {cfg.method} is ROADMAP item {item}")
    if cfg.comp_mesh:
        raise NotImplementedError("computational meshes are ROADMAP item A14")
    if cfg.n_devices > 1:
        raise NotImplementedError("multi-GPU runs are ROADMAP item A15")
    X, F, mask = build_geometry(cfg)
    mesh = MovingMesh(
        X, F, mask, get_monitor(cfg.dim, cfg.mon_type),
        rho=cfg.rho, tau=cfg.tau, dtype=_DTYPES[cfg.dtype], device=device,
    )
    if cfg.dim == 3:
        return mesh, _soa3d(cfg, mesh)
    if cfg.method == 1:
        from .integrators.euler import EulerIntegrator

        return mesh, EulerIntegrator(mesh, cfg.dt, cfg.nx, cfg.ny)
    if cfg.method == 2:
        from .integrators.backward_euler import BackwardEulerIntegrator

        return mesh, BackwardEulerIntegrator(mesh, cfg.dt, cfg.nx, cfg.ny,
                                             tol=cfg.step_tol)
    # the stencil engine's gate (problems.py:136-161 in the JAX package)
    if dense_layout(cfg.nx, cfg.ny, mesh) is None:
        raise NotImplementedError(
            "meshes off the stencil engine's gate run on the stock ADMM path "
            "(ROADMAP item A10)"
        )
    from .integrators.admm_grid2d import GridADMM2D

    integ = GridADMM2D(
        mesh, cfg.dt, cfg.nx, cfg.ny,
        admm_iters=cfg.admm_iter, tol=cfg.step_tol,
        prox_max_iters=cfg.prox_newton_iters, grad_use=cfg.grad_use,
    )
    return mesh, integ


def _soa3d(cfg: ExperimentConfig, mesh: MovingMesh):
    """The 3D stencil engine, or ``NotImplementedError`` for a mesh off
    its gate (``problems.py:93-127`` in the JAX package, without the size
    threshold; the monitor grid is constant or 48-wide, since
    ``build_monitor_grid`` builds no other 3D grid)."""
    if dense_layout_3d(cfg.nx, cfg.ny, cfg.nz, mesh) is None:
        raise NotImplementedError(
            "meshes off the stencil engine's gate run on the stock ADMM path "
            "(ROADMAP item A10)"
        )
    from .integrators.admm_soa import SoAADMM3D

    return SoAADMM3D(
        mesh, cfg.dt, cfg.nx, cfg.ny, cfg.nz,
        admm_iters=cfg.admm_iter, tol=cfg.step_tol,
        prox_max_iters=cfg.prox_newton_iters, grad_use=cfg.grad_use,
    )
