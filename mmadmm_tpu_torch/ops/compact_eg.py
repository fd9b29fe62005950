"""The compact, element-major ``(Ih, grad)`` evaluator and element
Hessians for explicit and backward Euler on any mesh (port of the compact
branches of ``mmadmm_tpu/integrators/euler.py:111-124`` and
``backward_euler.py:303-355, 382-418``).

The counterpart of ``ops/dense_eg2d.py``'s stencil evaluator, with the same
interface, for every mesh off that engine: 3D meshes, computational
meshes, FromFile and LevelSet meshes and 2D boxes off the stencil gate.

* ``eg(x)``: the ``Mesh::eulerStepMod`` gradient (``Mesh.cpp:533-579``,
  ``MovingMesh.gradient_interior``);
* ``hessians(x)``: the element Hessians ``He [NF, n, n]`` (n = D (D+1)),
  the forward derivative of the analytic element gradient with the
  interpolation cells frozen at ``x`` (cell indices are piecewise
  constant in position, so their tangent is 0): ``torch.func.vmap`` over
  ``torch.func.jvp`` in the n unit directions, as the generic prox builds
  its Jacobians (``ops/prox.py``), in slabs of ``mesh.jac_batch``
  elements (131,072 for 3D meshes over 300,000 elements), since the
  forward derivative holds n tangent copies of the gradient's
  intermediates;
* ``apply(He, v)``: ``D^T (He D v)``, a gather, the batched n x n product
  and the scatter (``backward_euler.py:339-355``);
* ``hdiag(He)``: ``D^T diag(He)``, the chord's Jacobi diagonal before its
  interior mask (``:404-418``);
* ``energy_hdiag(x)``: ``D^T diag(Hess e)`` of the element energies, the
  second derivative taken through the monitor sample, for the Jacobi
  preconditioner of ``precondition=True`` (``jac_diag``, ``:382-402``).

``eg``, ``hessians`` and ``apply`` run inside the ``record_function``
ranges ``RANGES``, which ``profile_step`` reads.

``ShardedEG`` is the same evaluator over the ranks of a
``parallel.RankGroup`` (``euler.py:32-62``, ``backward_euler.py:654-860``):
each rank takes its shard of the partition-ordered elements, padding
masked by ``valid``, and every gradient, energy and matvec ends in one
all-reduce, so that x and the Krylov vectors stay replicated, bit for bit.

Plain PyTorch on either device; there is no kernel here.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from . import huang
from .monitor_grid import gather_cell
from .reductions import sum_f64

RANGES = ("compact.eg", "compact.hessians", "compact.apply")  # the traced ranges


def _rows(t, sl):
    """A slab of a per-element tensor; a constant (``[D, D]`` Ehat) as it is."""
    return t if t.dim() == 2 else t[sl]


class CompactEG:
    def __init__(self, mesh):
        self.mesh = mesh
        self.dim = D = mesh.dim
        self.n = D * (D + 1)
        self.ehat = mesh.elem_ehat
        self.gather, self.scatter = mesh.gather, mesh.scatter_add

    def __call__(self, x):
        """``(Ih, grad)`` at node positions ``x``: Ih a float64 0-d tensor,
        grad ``[NP, D]`` masked to INTERIOR nodes."""
        with record_function(RANGES[0]):
            return self.mesh.gradient_interior(x)

    def energy(self, x):
        """``I_h(x)`` (``MovingMesh.energy``, the JAX ``_energy_impl``)."""
        return self.mesh.energy(x)

    def hessians(self, x):
        """The element Hessians ``[NF, n, n]``, ``[e, i, k] = d g_i / d z_k``."""
        mesh, n, D = self.mesh, self.n, self.dim
        with record_function(RANGES[1]):
            z = self.gather(x)
            cells = gather_cell(mesh.grid, z)
            zf = z.reshape(-1, n)
            nf = zf.shape[0]
            step = mesh.jac_batch or max(nf, 1)
            basis = torch.eye(n, dtype=zf.dtype, device=zf.device)[:, None, :]
            out = torch.empty((nf, n, n), dtype=zf.dtype, device=zf.device)
            for a in range(0, nf, step):
                sl = slice(a, a + step)
                c, eh = {k: v[sl] for k, v in cells.items()}, _rows(self.ehat, sl)

                def g(q):
                    return huang.element_energy_grad(q.reshape(-1, D + 1, D), c,
                                                     eh)[1].reshape(q.shape)

                q = zf[sl]
                cols = torch.func.vmap(lambda t: torch.func.jvp(g, (q,), (t,))[1])(
                    basis.expand(n, q.shape[0], n))
                out[sl] = cols.permute(1, 2, 0)
        return out

    def apply(self, He, v):
        """``D^T (He D v)``: ``[NP, D] -> [NP, D]``."""
        with record_function(RANGES[2]):
            ve = self.gather(v).reshape(-1, self.n, 1)
            return self.scatter(torch.bmm(He, ve).reshape(-1, self.dim + 1, self.dim))

    def hdiag(self, He):
        """``D^T diag(He)``: ``[NP, D]``."""
        return self.scatter(torch.diagonal(He, dim1=1, dim2=2).reshape(-1, self.dim + 1, self.dim))

    def energy_hdiag(self, x):
        """``D^T`` of the element energies' Hessian diagonals at ``x``:
        ``[NP, D]``. The Hessian of the summed energy is block diagonal, so
        one forward-over-reverse product per unit direction gives every
        element's diagonal entry in that coordinate."""
        mesh, n, D = self.mesh, self.n, self.dim
        z = mesh.gather(x)
        cells = gather_cell(mesh.grid, z)
        zf = z.reshape(-1, n)

        def total(q):
            return huang.element_energy(q.reshape(-1, D + 1, D), cells, mesh.elem_ehat).sum()

        grad = torch.func.grad(total)
        eye = torch.eye(n, dtype=zf.dtype, device=zf.device)
        cols = [torch.func.jvp(grad, (zf,), (eye[k].expand_as(zf),))[1][:, k] for k in range(n)]
        return mesh.scatter_add(torch.stack(cols, -1).reshape(-1, D + 1, D))


class ShardedEG(CompactEG):
    """``CompactEG`` over the ranks of ``group``: D x gathers the rank's
    elements, D^T is the rank's partial sum (padding masked by ``valid``)
    and one all-reduce, and the energy is the all-reduced sum of the
    rank's f64 partial sum."""

    def __init__(self, mesh, group):
        super().__init__(mesh)
        self.group = group
        self.shard = sh = mesh.shard(group)
        self.ehat, self.gather, self.scatter = sh.ehat, sh.gather, sh.scatter

    def _ih(self, ih_e):
        return self.group.all_reduce_sum(sum_f64(ih_e * self.shard.valid.reshape(-1)))

    def __call__(self, x):
        with record_function(RANGES[0]):
            z = self.gather(x)
            ih_e, g_e = huang.element_energy_grad(z, gather_cell(self.mesh.grid, z), self.ehat)
            return self._ih(ih_e), self.scatter(g_e) * self.mesh.interior_nodes

    def energy(self, x):
        z = self.gather(x)
        return self._ih(huang.element_energy(z, gather_cell(self.mesh.grid, z), self.ehat))
