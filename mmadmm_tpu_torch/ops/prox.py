"""The generic batched prox: the ADMM z-update on element-major blocks in
any dtype (port of ``mmadmm_tpu/ops/prox.py``: ``make_element_kernels``
and ``make_prox_solver``; reference ``Mesh::prox`` -> ``bfgsOptSimplex``,
``src/Mesh.cpp:931-994, 778-872``).

For every element it runs up to ``max_iters`` safeguarded Newton sweeps on
``I_h(z) + 0.5 w^2 |dxpu - z|^2``:

* the gradient is the reference's analytic formula
  (``huang.element_energy_grad`` with the prox term), masked by ``free``;
* the Jacobian of that gradient is its forward derivative
  (``torch.func.jvp`` over the ``n`` unit directions, batched with
  ``torch.func.vmap``: JAX's ``jacfwd``), with identity rows and columns
  on fixed coordinates and a 1e-9 Levenberg term, ``J f f^T + I (1 - f) +
  1e-9 I`` (``masked_jac``);
* ``solve_dir`` solves ``J p = -g`` by ``ops/linalg.py::ldlt_solve`` and
  takes ``-g / w^2`` where the step is not finite;
* chord sweeps with a refresh: the Jacobian of the prox entry is kept, and
  each sweep tries its step at alpha 1. An element that rejects that step
  takes the Jacobian at its current point (``J2``), a new solve and the
  backtracking schedule ``ALPHAS``; an element that accepts it keeps its
  Jacobian. The JAX package runs the refresh for the whole batch when any
  element rejects and keeps ``J`` where the step was accepted; computing
  ``J2`` only where it is kept gives the same values;
* an element retires when its gradient norm at the current point is below
  ``tol`` from the second sweep on (it does not move), or after a move
  whose step is below ``10 eps(dtype) (1 + max|z|)``.

``J_state = (J_in [NF, n, n], fresh)`` carries the chord Jacobian across
prox calls (ADMM iterations and time steps, ``integrators/admm.py``): the
entry Jacobian is built only when ``fresh`` is set, and the call returns
the updated ``J``. The JAX package sweeps the whole batch until no element
is active, so a retired element's ``J`` is still refreshed where it rejects
its chord step at its final point; the port sweeps only the active
elements and gives each element that stalled one such check in the next
sweep (an element that retires on its gradient norm was already checked at
its final point), which leaves ``J`` as the JAX package leaves it.

``jac_batch`` streams the Jacobian builds through slabs of that many
elements: the forward derivative holds ``n`` tangent copies of the
gradient's intermediates, the largest memory of the solve at 3D meshes of
several hundred thousand tets.

The Jacobian builds and the LDL^T solves run inside the ``record_function``
ranges ``RANGES``, which ``profile_step`` reads.

Plain PyTorch on either device; there is no kernel here.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from . import huang
from .linalg import ldlt_solve
from .monitor_grid import gather_cell

LEVENBERG = 1e-9
# backtracking: full Newton step, then halvings, then no move
ALPHAS = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.0)
RANGES = ("prox.masked_jac", "prox.ldlt_solve")  # the traced ranges


def _edet(zf, dim):
    """det E, the columns of E the element's edges, for flat ``zf [M, n]``."""
    zm = zf.reshape(zf.shape[0], dim + 1, dim)
    return huang._det((zm[:, 1:] - zm[:, :1]).transpose(-1, -2))


def _rows(t, rows):
    """``t[rows]`` of a per-element tensor; a constant (``[D, D]`` Ehat) as
    it is."""
    return t if t.dim() == 2 else t[rows]


class ElementKernels:
    """The per-element building blocks of the solve on a batch of elements
    (``make_element_kernels`` in the JAX package), all on flat ``[M, n]``
    blocks. ``cells`` are the frozen cells of the batch, ``ehat`` its
    Ehat (the constant ``[D, D]`` or ``[M, D, D]``)."""

    def __init__(self, w: float, dim: int):
        self.w, self.dim, self.n = float(w), dim, dim * (dim + 1)

    def _z(self, zf):
        return zf.reshape(zf.shape[0], self.dim + 1, self.dim)

    def grad(self, zf, cells, ehat, dxpuf):
        """The regularized gradient ``[M, n]``, unmasked."""
        _, g = huang.element_energy_grad(self._z(zf), cells, ehat, dxpu=self._z(dxpuf),
                                         w=self.w)
        return g.reshape(zf.shape)

    def grad_with_ih(self, zf, cells, ehat, dxpuf):
        """``(gradient [M, n], regularized energy [M])``: the energy from the
        gradient's unregularized ``I_h`` plus the prox term."""
        ih, g = huang.element_energy_grad(self._z(zf), cells, ehat, dxpu=self._z(dxpuf),
                                          w=self.w)
        e_reg = ih + 0.5 * self.w * self.w * ((dxpuf - zf) ** 2).sum(-1)
        return g.reshape(zf.shape), e_reg

    def reg_energy(self, zf, cells, ehat, dxpuf):
        return huang.element_energy(self._z(zf), cells, ehat, dxpu=self._z(dxpuf), w=self.w)

    def masked_jac(self, zf, cells, ehat, dxpuf, freef):
        """The gradient's Jacobian ``[M, n, n]`` with fixed coordinates
        replaced by identity, plus the Levenberg term."""
        n = self.n

        def g(zz):
            return self.grad(zz, cells, ehat, dxpuf)

        with record_function(RANGES[0]):
            eye = torch.eye(n, dtype=zf.dtype, device=zf.device)
            basis = eye[:, None, :].expand(n, zf.shape[0], n)
            cols = torch.func.vmap(lambda t: torch.func.jvp(g, (zf,), (t,))[1])(basis)
            J = cols.permute(1, 2, 0)  # [M, i, k] = d g_i / d z_k
            J = J * freef[:, :, None] * freef[:, None, :] + eye * (1.0 - freef)[:, None, :]
            return (J + LEVENBERG * eye).contiguous()

    def solve_dir(self, J, g):
        """The step ``-J^{-1} g``, or ``-g / w^2`` for an element whose step
        is not finite."""
        with record_function(RANGES[1]):
            p = ldlt_solve(J, -g)
        bad = ~torch.isfinite(p).all(-1, keepdim=True)
        w2 = torch.full((), self.w * self.w, dtype=g.dtype, device=g.device)
        return torch.where(bad, -g / w2, p)

    def trial_ok(self, zf, cells, ehat, dxpuf, e0, det_floor):
        """A finite regularized energy not above ``e0`` at an element whose
        orientation determinant stays above ``det_floor``."""
        e_a = self.reg_energy(zf, cells, ehat, dxpuf)
        return torch.isfinite(e_a) & (e_a <= e0) & (_edet(zf, self.dim) > det_floor)


def make_prox_solver(ehat, comp_mesh: bool, w: float, dim: int, jac_batch: int | None = None):
    """``prox(grid, z, xi, dxpu, free_mask, tol, max_iters, J_state=None)
    -> (z', ih0)``, or ``(z', ih0, J)`` with ``J_state``, on element-major
    ``z, dxpu, free_mask [NF, D+1, D]``. ``ehat`` is the constant ``[D, D]``
    Ehat; on a computational mesh (``comp_mesh``) each element's comes from
    its xi-mesh vertices ``xi [NF, D+1, D]`` (``huang._common_terms``),
    else ``xi`` is not read. ``ih0 [NF]`` is the unregularized energy at
    the input z. ``jac_batch``: the slab size of the Jacobian builds (None:
    the whole batch at once)."""
    k = ElementKernels(w, dim)
    n = k.n
    slab = int(jac_batch) if jac_batch else None

    def jac(rows, zf, cells, eh, dxpuf, freef):
        """``masked_jac`` of the elements ``rows`` (index tensor) at their
        points ``zf [M, n]``, slab by slab."""
        m = zf.shape[0]
        step = slab or max(m, 1)
        out = torch.empty((m, n, n), dtype=zf.dtype, device=zf.device)
        for a in range(0, m, step):
            r = rows[a:a + step]
            out[a:a + step] = k.masked_jac(zf[a:a + step], {c: v[r] for c, v in cells.items()},
                                           _rows(eh, r), dxpuf[r], freef[r])
        return out

    def prox(grid, z, xi, dxpu, free_mask, tol, max_iters, J_state=None):
        nf = z.shape[0]
        zf = z.reshape(nf, n)
        dxpuf = dxpu.reshape(nf, n)
        freef = free_mask.reshape(nf, n)
        cells = gather_cell(grid, z)  # frozen for the whole solve
        eh = (xi[:, 1:] - xi[:, :1]).transpose(1, 2) if comp_mesh else ehat
        ih0 = huang.element_energy(z, cells, eh)
        everyone = torch.arange(nf, device=z.device)
        if J_state is None or J_state[1]:
            J = jac(everyone, zf, cells, eh, dxpuf, freef)  # the entry Jacobian
        else:
            J = J_state[0].clone()
        eps = 10.0 * torch.finfo(z.dtype).eps
        out = zf.clone()
        active = everyone
        pending = everyone[:0]  # stalled last sweep: one more chord check, no move
        for it in range(int(max_iters)):
            if active.numel() == 0:
                break
            na = active.numel()
            rows = torch.cat([active, pending]) if pending.numel() else active
            zc = out[rows]
            c = {key: v[rows] for key, v in cells.items()}
            e_r, d_r, f_r = _rows(eh, rows), dxpuf[rows], freef[rows]
            g, e0 = k.grad_with_ih(zc, c, e_r, d_r)
            g = g * f_r
            gnorm = g.abs().sum(-1)
            p = k.solve_dir(J[rows], g)
            det_floor = torch.clamp_max(_edet(zc, dim), 0.0)
            ok1 = k.trial_ok(zc + p, c, e_r, d_r, e0, det_floor)
            alpha = torch.ones_like(gnorm)
            rej = torch.nonzero(~ok1).squeeze(1)
            if rej.numel():
                J2 = jac(rows[rej], zc[rej], cells, eh, dxpuf, freef)
                J[rows[rej]] = J2
                bt = rej[rej < na]  # the active rows that backtrack
                if bt.numel():
                    p2 = k.solve_dir(J2[:bt.numel()], g[bt])
                    z2, c2, e2, d2 = zc[bt], {key: v[bt] for key, v in c.items()}, \
                        _rows(e_r, bt), d_r[bt]
                    alpha_bt = torch.zeros_like(gnorm[bt])
                    for a in reversed(ALPHAS[:-1]):  # small -> large
                        ok = k.trial_ok(z2 + a * p2, c2, e2, d2, e0[bt], det_floor[bt])
                        alpha_bt = torch.where(ok, a, alpha_bt)
                    alpha[bt] = alpha_bt
                    p[bt] = p2
            # the active rows: retire, move, stall
            zc, p, alpha = zc[:na], p[:na], alpha[:na]
            step_inf = alpha * p.abs().amax(-1)
            stalled = step_inf <= eps * (1.0 + zc.abs().amax(-1))
            move = ~(gnorm[:na] < tol) if it > 0 else torch.ones_like(stalled)
            moved = active[move]
            out[moved] = zc[move] + alpha[move, None] * p[move]
            pending = active[move & stalled]
            active = active[move & ~stalled]
        z_opt = out.reshape(nf, dim + 1, dim)
        if J_state is None:
            return z_opt, ih0
        return z_opt, ih0, J

    return prox
