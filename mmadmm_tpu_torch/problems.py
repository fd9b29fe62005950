"""Experiment setup: config -> (mesh, integrator) (port of
``mmadmm_tpu/problems.py``; reference ``main.cpp:142-782``).

The port runs MM-ADMM (method 0), explicit Euler (method 1) and backward
Euler (method 2) on the 2D stencil engine, MM-ADMM on the 3D stencil
engine (the JAX package's ``SoAADMM3D`` in stencil mode), MM-ADMM on the
stock element-major engine (``ADMMIntegrator``) for every other mesh, and
explicit and backward Euler on the compact element-major path
(``ops/compact_eg.py``) for every mesh off the 2D stencil engine: 3D
meshes, computational meshes, FromFile and LevelSet meshes and 2D boxes
off the gate, and every backward-Euler run with an inner solver other
than ``neumann``.

Box meshes (SquareGrid, Shoulder) on the stencil gate, with a monitor
grid the kernels read (``MonitorGrid.kernel_table``), take their
stencil engine in float32 and in float64, with the engine's kernels built
in the mesh's dtype (K1, K2 and K3 in 2D, K4 in 3D), as the JAX package
builds its Pallas kernels in the mesh's dtype (``admm_grid2d.py:158-163``,
``admm_soa.py:241-246``, ``backward_euler.py:233-249``). A box mesh from a
JSON configuration (float64, ``"auto"``) thus runs as ``python run.py
<config>`` runs it in the JAX package. The exceptions, on the stock
engine: ``prox_backend="vmap"`` (the generic prox, asked for), a
computational mesh, and a 3D box mesh with ``prox_chord=True``: the JAX SoA
engine builds its kernel with ``chord=False`` (``admm_soa.py:244``) and
sends box meshes under 500,000 tets to the stock engine anyway
(``problems.py:93-103``).

Every other mesh takes the stock engine on the mesh's prox route
(``MovingMesh``'s ``prox_backend``): FromFile and LevelSet meshes, 2D
meshes off the stencil gate and computational meshes (which the JAX
package keeps off its SoA engine, ``problems.py:106-111``). In float64
under ``"auto"`` that is the generic prox with the carried chord Jacobian,
the JAX package's default. The JAX package also gates the stencil engines
on mesh size (and, for Euler and backward Euler, on environment switches),
the port on the mesh alone.

A run over ``n_devices > 1`` ranks (``problems.py:83-86`` in the JAX
package) takes the sharded stock engine for MM-ADMM
(``admm.ShardedADMMIntegrator``) and the sharded compact path for methods
1 and 2, whatever the mesh: the JAX stencil engines require
``device_mesh is None`` (``problems.py:107, 143``) and its sharded Euler
and backward Euler take no stencil dims. Each rank calls
``build_problem`` with its ``parallel.RankGroup`` (``group``, or the
group of a ``torchrun`` rank), on the group's device.
"""

from __future__ import annotations

import os

import torch

from .config import ExperimentConfig
from .geometry import io as mesh_io
from .geometry.level_set import circle_phi, mesh_from_level_set, sphere_phi
from .geometry.node_type import NodeType
from .geometry.rect_mesh import generate_uniform_rect_mesh
from .geometry.shoulder import make_shoulder_mesh
from .mesh import MovingMesh
from .monitors import get_monitor
from .ops.stencil2d import dense_layout
from .ops.stencil3d import dense_layout_3d

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build_geometry(cfg: ExperimentConfig):
    """``(X, F, mask)`` for SquareGrid, Shoulder, LevelSet (the circle in
    2D, the sphere in 3D, ``main.cpp:333-397``) and FromFile
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
        phi, normal = (circle_phi, "circle") if cfg.dim == 2 else (sphere_phi, "grad")
        return mesh_from_level_set(phi, *args, normal=normal)
    raise ValueError(f"unknown TestType {cfg.test_type!r}")


def build_problem(cfg: ExperimentConfig, device=None, *, prox_chord: bool | None = None,
                  group=None, halo: bool = True):
    """Return ``(mesh, integrator)`` ready to run, on ``device`` (CUDA
    unless the caller asks for the CPU). ``prox_chord`` picks chord or
    Newton sweeps in the 3D prox kernel (``MovingMesh``; None: chord
    sweeps on a computational mesh only). Over ranks this is one rank's
    part: ``group`` (a ``parallel.RankGroup``) gives the rank, the rank
    count and the device, whatever ``cfg.n_devices`` says; without a
    group, ``cfg.n_devices > 1`` takes a ``torchrun`` rank's. ``halo`` is
    the sharded MM-ADMM step's exchange."""
    if cfg.method not in (0, 1, 2):
        raise ValueError(f"unknown method {cfg.method}")
    if group is None and cfg.n_devices > 1:
        from .parallel.group import group_from_env, in_torchrun

        if not in_torchrun():
            raise RuntimeError(
                f"n_devices={cfg.n_devices} needs one process a rank: start them with "
                "parallel.launch or torchrun")
        group = group_from_env(device=device)
    if group is not None:
        device = group.device
        if group.size == 1:
            group = None
    X, F, mask = build_geometry(cfg)
    mesh = MovingMesh(
        X, F, mask, get_monitor(cfg.dim, cfg.mon_type),
        rho=cfg.rho, tau=cfg.tau, comp_mesh=cfg.comp_mesh, Xc=X if cfg.comp_mesh else None,
        dtype=_DTYPES[cfg.dtype], device=device, prox_backend=cfg.prox_backend,
        prox_chord=prox_chord,
    )
    box = cfg.test_type in ("SquareGrid", "Shoulder")
    # the grid dims of a 2D box, for the stencil engine of methods 1 and 2
    # (problems.py:167-185 in the JAX package); without them, or off the
    # gate, they run on the compact path
    grid2d_dims = ((cfg.nx, cfg.ny) if box and cfg.dim == 2 and not cfg.comp_mesh
                   and mesh.grid.kernel_table else None)
    if group is not None:
        grid2d_dims = None
    if cfg.method == 1:
        from .integrators.euler import EulerIntegrator

        return mesh, EulerIntegrator(mesh, cfg.dt, grid2d_dims=grid2d_dims, group=group)
    if cfg.method == 2:
        from .integrators.backward_euler import BackwardEulerIntegrator

        return mesh, BackwardEulerIntegrator(mesh, cfg.dt, grid2d_dims=grid2d_dims,
                                             tol=cfg.step_tol, group=group)
    if group is not None:
        from .integrators.admm import ShardedADMMIntegrator

        return mesh, ShardedADMMIntegrator(mesh, cfg.dt, group, halo=halo, **_stock_kw(cfg))
    if cfg.prox_backend == "vmap" or cfg.comp_mesh or not box or not mesh.grid.kernel_table:
        return mesh, _stock(cfg, mesh)
    if cfg.dim == 3:
        # the 3D stencil engine's gate (problems.py:93-127 in the JAX
        # package, without the size threshold; the monitor grid constant or
        # 48-wide)
        if not mesh.prox_chord and dense_layout_3d(cfg.nx, cfg.ny, cfg.nz, mesh) is not None:
            return mesh, _soa3d(cfg, mesh)
        return mesh, _stock(cfg, mesh)
    # the stencil engine's gate (problems.py:136-161 in the JAX package)
    if dense_layout(cfg.nx, cfg.ny, mesh) is None:
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
    package), with the chord-Jacobian carry's default rule."""
    from .integrators.admm import ADMMIntegrator

    return ADMMIntegrator(mesh, cfg.dt, **_stock_kw(cfg))


def _stock_kw(cfg: ExperimentConfig) -> dict:
    return dict(admm_iters=cfg.admm_iter, tol=cfg.step_tol,
                prox_max_iters=cfg.prox_newton_iters, grad_use=cfg.grad_use)


def _soa3d(cfg: ExperimentConfig, mesh: MovingMesh):
    """The 3D stencil engine."""
    from .integrators.admm_soa import SoAADMM3D

    return SoAADMM3D(
        mesh, cfg.dt, cfg.nx, cfg.ny, cfg.nz,
        admm_iters=cfg.admm_iter, tol=cfg.step_tol,
        prox_max_iters=cfg.prox_newton_iters, grad_use=cfg.grad_use,
    )
