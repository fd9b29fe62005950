"""The dense-grid ``(Ih, grad)`` evaluator for structured 2D meshes (port
of ``mmadmm_tpu/ops/dense_eg2d.py``).

The ``Mesh::eulerStepMod`` gradient (``Mesh.cpp:533-579``): unmasked
per-element gradients, scattered to all nodes, then masked to INTERIOR
nodes. On the stencil engine that is a window-slice gather of the slot
positions, the cell-row fetch, kernel K2 (``ops/be2d.py::eg2d``) and a
shifted pad-add scatter. Explicit Euler calls it once per step; backward
Euler also takes its gather, scatter and cell fetch for the Hessian
kernel K3 and its matvec.
"""

from __future__ import annotations

import numpy as np
import torch

from .be2d import eg2d, hess2d
from .monitor_grid import cell_rows48
from .reductions import sum_f64
from .stencil2d import dense_layout, make_stencil_ops


class DenseEG2D:
    """The stencil constants of one structured 2D mesh and its ``(Ih,
    grad)`` evaluation. Slots are the ``NFd = 4 nx ny`` dense element
    slots; carved slots ride along masked out (``alive_k``, ``valid``)."""

    def __init__(self, mesh, nx: int, ny: int, alive, swapped, mesh_of_dense):
        def planes(v):  # dense [NFd] -> per-k cell planes [4, ny, nx]
            return v.reshape(ny, nx, 4).transpose(2, 0, 1)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64),
                                   dtype=mesh.dtype, device=mesh.device)

        self.mesh = mesh
        self.NFd = 4 * nx * ny
        self.swap_k = t(planes(swapped))
        self.alive_k = t(planes(alive))
        self.valid = t(alive)  # [NFd]
        self.mesh_of_dense = mesh_of_dense  # [NFd] int64, the mesh element of a slot (-1 carved)
        self._gather_ch, self._scatter_ch = make_stencil_ops(nx, ny)

    def gather(self, x):
        """D x: node field ``[NP, 2]`` -> slot values ``[6, NFd]``."""
        return self._gather_ch(x, self.swap_k)

    def scatter(self, y):
        """D^T y over live slots: ``[6, NFd]`` -> ``[NP, 2]``."""
        return self._scatter_ch(y, self.swap_k, self.alive_k)

    def cells(self, z):
        """The slots' cell rows ``[48, NFd]`` at slot positions ``z``."""
        return cell_rows48(self.mesh.grid, z)

    def __call__(self, x):
        """``(Ih, grad)`` at node positions ``x``: Ih a float64 0-d tensor,
        grad ``[NP, 2]`` masked to INTERIOR nodes."""
        z = self.gather(x)
        g, ih = eg2d(z, self.cells(z), self.mesh.ehat_np.reshape(-1))
        # where, not a product: a dead slot's ih may be non-finite
        ih = sum_f64(torch.where(self.valid > 0, ih, 0.0))
        return ih, self.scatter(g) * self.mesh.interior_nodes

    def energy(self, x):
        """``I_h(x)``, a float64 0-d tensor (K2)."""
        return self(x)[0]

    def hessians(self, x):
        """The slots' element Hessians at ``x``, their lower triangle
        ``[21, NFd]`` (K3)."""
        z = self.gather(x)
        return hess2d(z, self.cells(z), self.mesh.ehat_np.reshape(-1))

    def apply(self, He, v):
        """``D^T (He D v)`` for the triangle ``He``: ``[NP, 2] -> [NP, 2]``."""
        vz = self.gather(v)
        hv = []
        for i in range(6):
            acc = He[tri(i, 0)] * vz[0]
            for j in range(1, 6):
                acc = acc + He[tri(i, j)] * vz[j]
            hv.append(acc)
        return self.scatter(torch.stack(hv))

    def hdiag(self, He):
        """``D^T diag(He)``: ``[NP, 2]``."""
        return self.scatter(torch.stack([He[tri(i, i)] for i in range(6)]))


def tri(i: int, j: int) -> int:
    """Channel of ``H[i][j]`` in K3's lower-triangle layout."""
    i, j = max(i, j), min(i, j)
    return i * (i + 1) // 2 + j


def make_dense_eg2d(mesh, nx: int, ny: int):
    """The evaluator for a mesh on the (nx, ny) rect grid, or ``None`` if
    the mesh is off the stencil engine's gate (``stencil2d.dense_layout``)."""
    layout = dense_layout(nx, ny, mesh)
    if layout is None:
        return None
    return DenseEG2D(mesh, nx, ny, *layout)
