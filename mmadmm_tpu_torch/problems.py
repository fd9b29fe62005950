"""Experiment setup: config -> (mesh, integrator) (port of
``mmadmm_tpu/problems.py``; reference ``main.cpp:142-782``).

The port runs MM-ADMM (method 0), explicit Euler (method 1) and backward
Euler (method 2) on the 2D stencil engine, MM-ADMM on the 3D stencil
engine (the JAX package's ``SoAADMM3D`` in stencil mode), and MM-ADMM on
the stock element-major engine (``ADMMIntegrator``) for every other
float32 mesh: FromFile meshes, 2D meshes off the stencil gate, and 3D
computational meshes, which the JAX package keeps off its SoA engine
(``problems.py:106-111``). Every other route raises
``NotImplementedError`` naming the ROADMAP item that ports it. The JAX
package also gates the stencil engines on mesh size (and, for Euler and
backward Euler, on environment switches); the port sends every mesh that
fits a stencil engine there.
"""

from __future__ import annotations

import torch

import os

from .config import ExperimentConfig
from .geometry import io as mesh_io
from .geometry.node_type import NodeType
from .geometry.rect_mesh import generate_uniform_rect_mesh
from .geometry.shoulder import make_shoulder_mesh
from .mesh import MovingMesh
from .monitors import get_monitor
from .ops.stencil2d import dense_layout
from .ops.stencil3d import dense_layout_3d

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build_geometry(cfg: ExperimentConfig):
    """``(X, F, mask)`` for SquareGrid, Shoulder and FromFile
    (``main.cpp:874-904``); FromFile paths are relative to
    ``cfg.base_dir``. The computational mesh of a ``comp_mesh`` run is
    ``X`` itself (``problems.py:30-66`` in the JAX package)."""
    btype = NodeType(cfg.boundary_node_type)
    args = (cfg.dim, cfg.nx, cfg.ny, cfg.nz, cfg.xa, cfg.xb, cfg.ya, cfg.yb,
            cfg.za, cfg.zb, btype)
    if cfg.test_type == "SquareGrid":
        return generate_uniform_rect_mesh(*args)
    if cfg.test_type == "Shoulder":
        return make_shoulder_mesh(*args)
    if cfg.test_type == "FromFile":
        return mesh_io.read_mesh(
            *(os.path.join(cfg.base_dir, p)
              for p in (cfg.triangles_file, cfg.pnts_file, cfg.mask_file))
        )
    if cfg.test_type == "LevelSet":
        raise NotImplementedError("LevelSet meshes are ROADMAP item A10")
    raise ValueError(f"unknown TestType {cfg.test_type!r}")


def build_problem(cfg: ExperimentConfig, device=None):
    """Return ``(mesh, integrator)`` ready to run, on ``device`` (CUDA
    unless the caller asks for the CPU)."""
    if cfg.method not in (0, 1, 2):
        raise ValueError(f"unknown method {cfg.method}")
    if cfg.dim == 3 and cfg.method != 0:
        item = "A11" if cfg.method == 1 else "A12"
        raise NotImplementedError(f"3D method {cfg.method} is ROADMAP item {item}")
    if cfg.comp_mesh and cfg.dim == 2:
        raise NotImplementedError(
            "2D computational meshes need the generic prox (ROADMAP item A14)"
        )
    if cfg.n_devices > 1:
        raise NotImplementedError("multi-GPU runs are ROADMAP item A15")
    if cfg.prox_backend == "vmap":
        raise NotImplementedError("the generic vmap prox is ROADMAP item A10")
    if cfg.prox_backend not in ("auto", "pallas"):
        raise ValueError(f"unknown prox_backend {cfg.prox_backend!r}")
    X, F, mask = build_geometry(cfg)
    mesh = MovingMesh(
        X, F, mask, get_monitor(cfg.dim, cfg.mon_type),
        rho=cfg.rho, tau=cfg.tau, comp_mesh=cfg.comp_mesh, Xc=X if cfg.comp_mesh else None,
        dtype=_DTYPES[cfg.dtype], device=device,
    )
    box = cfg.test_type in ("SquareGrid", "Shoulder")
    if cfg.dim == 3:
        # the 3D stencil engine's gate (problems.py:93-127 in the JAX
        # package, without the size threshold; the monitor grid is constant
        # or 48-wide, since build_monitor_grid builds no other 3D grid)
        if (box and not cfg.comp_mesh
                and dense_layout_3d(cfg.nx, cfg.ny, cfg.nz, mesh) is not None):
            return mesh, _soa3d(cfg, mesh)
        return mesh, _stock(cfg, mesh)
    if cfg.method == 1:
        from .integrators.euler import EulerIntegrator

        return mesh, EulerIntegrator(mesh, cfg.dt, cfg.nx, cfg.ny)
    if cfg.method == 2:
        from .integrators.backward_euler import BackwardEulerIntegrator

        return mesh, BackwardEulerIntegrator(mesh, cfg.dt, cfg.nx, cfg.ny,
                                             tol=cfg.step_tol)
    # the stencil engine's gate (problems.py:136-161 in the JAX package)
    if not box or dense_layout(cfg.nx, cfg.ny, mesh) is None:
        return mesh, _stock(cfg, mesh)
    from .integrators.admm_grid2d import GridADMM2D

    integ = GridADMM2D(
        mesh, cfg.dt, cfg.nx, cfg.ny,
        admm_iters=cfg.admm_iter, tol=cfg.step_tol,
        prox_max_iters=cfg.prox_newton_iters, grad_use=cfg.grad_use,
    )
    return mesh, integ


def _stock(cfg: ExperimentConfig, mesh: MovingMesh):
    """The stock element-major engine (``problems.py:162-167`` in the JAX
    package)."""
    from .integrators.admm import ADMMIntegrator

    return ADMMIntegrator(
        mesh, cfg.dt,
        admm_iters=cfg.admm_iter, tol=cfg.step_tol,
        prox_max_iters=cfg.prox_newton_iters, grad_use=cfg.grad_use,
    )


def _soa3d(cfg: ExperimentConfig, mesh: MovingMesh):
    """The 3D stencil engine."""
    from .integrators.admm_soa import SoAADMM3D

    return SoAADMM3D(
        mesh, cfg.dt, cfg.nx, cfg.ny, cfg.nz,
        admm_iters=cfg.admm_iter, tol=cfg.step_tol,
        prox_max_iters=cfg.prox_newton_iters, grad_use=cfg.grad_use,
    )
