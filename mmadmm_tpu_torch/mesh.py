"""MovingMesh: mesh state and its operators on one device (port of
``mmadmm_tpu/mesh.py``; reference ``Mesh<D>``, ``src/Mesh.h``), D = 2 or 3.

* ``X [NP, D]`` node positions, ``F [NF, D+1]`` connectivity (reoriented
  to positive orientation, ``Mesh.cpp:244-260``), ``mask [NP]`` NodeType,
* the reference's sparse operators (``M = tau I``, ``Dmat``, ``W = w I``;
  ``Mesh.cpp:677-753``) as a scalar ``tau``, a gather / degree-padded sum
  pair, a scalar ``w`` and the node degrees (the diagonal of ``D^T D``),
* the monitor background grid and its cell table, built once
  (``Mesh.cpp:431-433``),
* the Ehat the functional divides by: the constant reference one, or on a
  computational mesh (``comp_mesh``, the xi-mesh ``Xc``) one per element,
  ``E(xi)`` of the element's computational vertices
  (``AdaptationFunctional.cpp:176-201``).

Reference quirk kept: the JSON ``w`` is overridden by
``w = 0.5 sqrt(rho)`` (``Mesh.cpp:451``).

The prox (``prox_fn``, chosen as in ``mesh.py:126-203`` of the JAX
package) is one of two routes, ``prox_backend``:

* ``"pallas"``, the kernels: K1 in 2D (``ops/prox2d.py``); in 3D K4, K4'
  or K4'' (``ops/prox3d.py``), chosen by the computational mesh and
  ``prox_chord``. Each launches its CUDA kernel, built in the mesh's
  dtype (float32 or float64), on a CUDA tensor and runs its plain PyTorch
  version on a CPU tensor. K1 has no computational-mesh mode;
* ``"vmap"``, the generic batched prox (``ops/prox.py``) in the mesh's
  dtype, the JAX package's default.

``"auto"`` takes the kernels where a float32 kernel computes the function
(not a 2D computational mesh, and a grid with the symmetric cell table,
``mesh.py:128-150`` in the JAX package) and the generic prox elsewhere:
float64 (the
JAX package's default, ``mesh.py:126``, which also reaches its float64
kernels only through ``"pallas"``), and 2D computational meshes. The
stencil engines take their own kernel in the mesh's dtype whatever the
route (``problems.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .geometry import topology
from .geometry.node_type import NodeType
from .ops import huang, prox2d, prox3d
from .ops.monitor_grid import build_monitor_grid, gather_cell
from .ops.prox import make_prox_solver
from .ops.reductions import sum_f64
from .ops.scatter import gather_elements, scatter_add_dense
from .runtime.device import resolve_device


class MovingMesh:
    def __init__(
        self,
        X: np.ndarray,
        F: np.ndarray,
        mask: np.ndarray,
        monitor,
        *,
        rho: float,
        tau: float,
        comp_mesh: bool = False,
        Xc: np.ndarray | None = None,
        dtype=torch.float64,
        device=None,
        prox_backend: str = "auto",
        prox_chord: bool | None = None,
        jac_batch: int | None = None,
    ):
        """``prox_chord``: chord sweeps in the 3D prox kernel (K4' and
        K4''a) or Newton sweeps (K4 and K4''b); None takes chord sweeps on a
        computational mesh only (the JAX package's ``MMADMM_PROX_CHORD``,
        ``mesh.py:183-187``). ``jac_batch``: the slab size of the generic
        prox's Jacobian builds; None takes the JAX package's rule
        (``mesh.py:157-166``: 131,072 for 3D meshes of over 300,000
        elements, else the whole batch), 0 the whole batch."""
        X = np.asarray(X, dtype=np.float64)
        F = np.asarray(F, dtype=np.int32)
        mask = np.asarray(mask, dtype=np.int8)
        self.dim = D = X.shape[1]
        self.device = device = resolve_device(device)
        self.dtype = dtype
        self.n_pnts = X.shape[0]

        F = topology.reorient_elements(X, F)  # Mesh.cpp:408 -> 244-260
        self.n_elements = F.shape[0]
        self.tau = float(tau)
        self.w = 0.5 * math.sqrt(rho)  # Mesh.cpp:451 (overrides JSON w)

        deg = topology.node_degrees(F, self.n_pnts)
        dense_idx, _ = topology.dense_scatter_plan(F, self.n_pnts)
        self.grid = build_monitor_grid(X, monitor, dtype=dtype, device=device)

        def t(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

        self._X_np, self._F_np = X, F
        self.mask_np = mask  # NodeType per node, as the run artifacts' mask.txt
        fixed_v = mask[F] == NodeType.BOUNDARY_FIXED  # [NF, D+1]
        self._elem_free_np = np.repeat(~fixed_v[:, :, None], D, axis=2).astype(np.float64)
        self.X0 = t(X)
        self.F = t(F, torch.int64)
        self.deg = t(deg)
        self.dense_idx = t(dense_idx, torch.int64)
        self.elem_free = t(self._elem_free_np)  # [NF, D+1, D], 1.0 where movable
        # [NP, 1], 1.0 at INTERIOR nodes: explicit and backward Euler mask
        # the assembled node gradient with it (Mesh::eulerStepMod)
        self.interior_nodes = t((mask == NodeType.INTERIOR).astype(np.float64)[:, None])
        self.ehat_np = huang.reference_ehat(D, self.n_elements)  # float64
        self.ehat = t(self.ehat_np)
        self.comp_mesh = bool(comp_mesh)
        if self.comp_mesh:
            if Xc is None:
                raise ValueError("comp_mesh needs the computational mesh Xc")
            # xi = Xc[F] in the working dtype, then per element
            # Ehat[d, j] = xi_{j+1, d} - xi_{0, d} (huang._common_terms)
            self._xi_np = np.asarray(Xc, dtype=np.float64)[F]
            self.xi = t(self._xi_np)  # [NF, D+1, D]
            self.elem_ehat = (self.xi[:, 1:] - self.xi[:, :1]).transpose(1, 2)
        else:
            self._xi_np = self.xi = None
            self.elem_ehat = self.ehat
        self._select_prox(prox_backend, prox_chord, jac_batch)

    def _select_prox(self, backend, chord, jac_batch):
        """Set ``prox_backend``, ``prox_chord``, ``jac_batch`` and
        ``prox_fn(grid, z, xi, dxpu, free_mask, tol, max_iters[,
        J_state])``."""
        self.prox_chord = self.comp_mesh if chord is None else bool(chord)
        f32 = self.dtype == torch.float32
        comp2d = self.dim == 2 and self.comp_mesh
        if backend == "auto":
            backend = "pallas" if f32 and self.grid.kernel_table and not comp2d else "vmap"
        if backend not in ("pallas", "vmap"):
            raise ValueError(f"unknown prox_backend {backend!r}")
        if backend == "pallas" and comp2d:
            raise ValueError(
                "prox_backend 'pallas': K1 has no computational-mesh mode; use 'vmap' or 'auto'"
            )
        if backend == "pallas" and not self.grid.kernel_table:
            raise ValueError(
                "prox_backend 'pallas': the kernels read only the symmetric cell table; this "
                "monitor is not symmetric; use 'vmap' or 'auto'"
            )
        self.prox_backend = backend
        w = self.w
        if jac_batch is None:
            jac_batch = 131_072 if self.dim == 3 and self.n_elements > 300_000 else 0
        self.jac_batch = jac_batch or None  # the generic prox's slab (None: the whole batch)
        if backend == "vmap":
            self.prox_fn = make_prox_solver(self.ehat, self.comp_mesh, w, self.dim,
                                            jac_batch=self.jac_batch)
            return
        if self.dim == 2:
            def prox_fn(grid, z, xi, dxpu, free, tol, max_iters):
                return prox2d.prox_elements(grid, z, dxpu, free, self.ehat_np.reshape(-1), w,
                                            tol, max_iters)
        else:
            def prox_fn(grid, z, xi, dxpu, free, tol, max_iters):
                return prox3d.prox_elements(grid, z, xi, dxpu, free, w, tol, max_iters,
                                            ehat=self.ehat_np.reshape(-1),
                                            chord=self.prox_chord)
        self.prox_fn = prox_fn

    def project_onto_boundary(self, x: torch.Tensor, ref_x: torch.Tensor | None = None):
        """Free-slip projection of the BOUNDARY_FREE nodes of the proposal
        ``x`` onto their incident boundary faces at the committed positions
        ``ref_x`` (default ``x``; pass the positions before the step)
        (``Mesh::projectOntoBoundary``, ``Mesh.cpp:119-241``). The
        reference leaves it unused; no integrator calls it."""
        if not hasattr(self, "_boundary_projector"):
            from .ops.boundary import make_boundary_projector

            faces = topology.build_boundary_faces(self._F_np, self.mask_np)
            self._boundary_projector = make_boundary_projector(faces, self.mask_np, self.dim)
        return self._boundary_projector(x, ref_x)

    def prox(self, z, xi, dxpu, free_mask, tol, max_iters):
        """The prox on every element with this mesh's grid: ``(z', ih0)``."""
        return self.prox_fn(self.grid, z, xi, dxpu, free_mask, tol, max_iters)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """D x (Mesh::buildDMatrix semantics): ``[NP, D] -> [NF, D+1, D]``."""
        return gather_elements(x, self.F)

    def scatter_add(self, vals: torch.Tensor) -> torch.Tensor:
        """D^T y: ``[NF, D+1, D] -> [NP, D]``."""
        return scatter_add_dense(vals, self.dense_idx)

    def energy_of_z(self, z: torch.Tensor) -> torch.Tensor:
        """Sum of unregularized element energies at element-stacked z,
        in float64."""
        return sum_f64(huang.element_energy(z, gather_cell(self.grid, z), self.elem_ehat))

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        """Mesh::computeEnergy (Mesh.cpp:497-530), summed in float64."""
        return self.energy_of_z(self.gather(x))

    def gradient(self, x: torch.Tensor):
        """``(Ih, grad [NP, D])`` for the ADMM predictor
        (``Mesh::eulerGrad``, Mesh.cpp:583-624): BOUNDARY_FIXED vertex
        components are zeroed per element before the scatter to nodes."""
        z = self.gather(x)
        ih_e, g_e = huang.element_energy_grad(z, gather_cell(self.grid, z), self.elem_ehat)
        return sum_f64(ih_e), self.scatter_add(g_e * self.elem_free)

    def gradient_interior(self, x: torch.Tensor):
        """``(Ih, grad [NP, D])`` for explicit and backward Euler
        (``Mesh::eulerStepMod``, Mesh.cpp:533-579): the element gradients
        unmasked, scattered to every node, then masked to INTERIOR nodes."""
        z = self.gather(x)
        ih_e, g_e = huang.element_energy_grad(z, gather_cell(self.grid, z), self.elem_ehat)
        return sum_f64(ih_e), self.scatter_add(g_e) * self.interior_nodes

    def build_shards(self, n_shards: int):
        """Partition-ordered, padded element shards for a run over
        ``n_shards`` ranks (``parallel.spmd.build_elem_shards``)."""
        from .parallel.spmd import build_elem_shards

        # xi is zeros off a computational mesh, as in the JAX package (never read)
        xi = self._xi_np if self.comp_mesh else np.zeros(self._elem_free_np.shape)
        return build_elem_shards(self._X_np, self._F_np, xi, self._elem_free_np, self.n_pnts,
                                 n_shards)

    def shard(self, group):
        """This rank's part of the elements over ``group``
        (``parallel.spmd.MeshShard``), on the group's device."""
        from .parallel.spmd import MeshShard

        return MeshShard(self, group)
