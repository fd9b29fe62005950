"""Frozen copy of ``mmadmm_tpu_torch/ops/newton.py`` for the benchmark's reference.

The prox's damped-Newton sweep on channel lists (the plain K4's): one
sweep is the gradient, the Hessian, ``ldlt_c``, the ``-g/w^2`` fallback,
5 backtracking trials and the retire rules; the sweep retires on the
gradient before it builds the Hessian. The forward-mode rules are those
the Pallas kernels got from ``jax.jvp``. An element's state is a list of
12 channel tensors ``[N]``.

Every operation is written so that the CUDA kernels (``csrc/*.cu``,
built with ``--fmad=false``) can repeat it bit for bit: the same order of
operations, IEEE division and square root, and constants rounded as JAX
rounds them in the working dtype (a Python float that meets a tile is cast
to the tile's dtype first: to f32 in a float32 run, nothing in a float64
one). Everything runs in float32 or float64, the dtype of the inputs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

DET_FLOOR = 1e-30
DIAG_FLOOR = 1e-12
LEVENBERG = 1e-9
ALPHAS_BT = (0.0625, 0.125, 0.25, 0.5, 1.0)  # small -> large
# the dtypes the prox kernels are built in, with their NumPy scalar types
DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def rnd(v: float, dtype) -> float:
    """A Python float rounded to ``dtype`` (float32 or float64), as JAX
    casts it where it meets a tile of that dtype."""
    return float(DTYPES[dtype](v))


def eps_stall(dtype) -> float:
    """The stall tolerance ``10 * finfo(dtype).eps`` in ``dtype``
    (``prox_pallas2d.py:346``)."""
    return rnd(10.0 * np.finfo(DTYPES[dtype]).eps, dtype)


class Dual:
    """Forward-mode dual number over tensors: value ``v [N]`` and
    tangents ``d [K, N]`` (K directions at once). The derivative rules are
    JAX's jvp rules (``lax.mul``, ``lax.div``, ``sqrt``, ``max``,
    ``abs``), and the CUDA kernels apply the same ones."""

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v = v
        self.d = d

    def __add__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v + o.v, self.d + o.d)
        return Dual(self.v + o, self.d)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v - o.v, self.d - o.d)
        return Dual(self.v - o, self.d)

    def __rsub__(self, o):
        return Dual(o - self.v, -self.d)

    def __neg__(self):
        return Dual(-self.v, -self.d)

    def __mul__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v * o.v, self.d * o.v + self.v * o.d)
        return Dual(self.v * o, self.d * o)

    def __rmul__(self, o):
        return Dual(o * self.v, o * self.d)

    def __truediv__(self, o):
        if isinstance(o, Dual):
            r = 1.0 / (o.v * o.v)
            return Dual(self.v / o.v, self.d / o.v + (-o.d * self.v) * r)
        return Dual(self.v / o, self.d / o)

    def __rtruediv__(self, o):
        r = 1.0 / (self.v * self.v)
        return Dual(o / self.v, (-self.d * o) * r)


def dtype_of(x):
    """The dtype of a channel tensor or of a dual number's value."""
    return x.v.dtype if isinstance(x, Dual) else x.dtype


def sqrt(x):
    if isinstance(x, Dual):
        s = torch.sqrt(x.v)
        return Dual(s, x.d * (0.5 / s))
    return torch.sqrt(x)


def max_floor(x, c):
    """``max(x, c)`` for a constant c; NaN propagates."""
    if isinstance(x, Dual):
        f = torch.where(x.v > c, 1.0, torch.where(x.v == c, 0.5, 0.0))
        return Dual(torch.clamp_min(x.v, c), x.d * f)
    return torch.clamp_min(x, c)


def absolute(x):
    if isinstance(x, Dual):
        return Dual(torch.abs(x.v), torch.where(x.v >= 0, x.d, -x.d))
    return torch.abs(x)


def hessian(grad_fn, z, free):
    """Lower triangle ``H[i][j]`` (i >= j) of the derivative of
    ``grad_fn(z) -> (grads, ...)``, from one dual pass carrying all
    ``n`` directions. Fixed coordinates (``free`` 0) get identity rows
    and columns, every diagonal the Levenberg term (``hess_c``)."""
    n, m = len(z), z[0].shape[0]
    eye = torch.eye(n, dtype=z[0].dtype, device=z[0].device)
    dg = grad_fn([Dual(z[i], eye[i][:, None].expand(n, m)) for i in range(n)])[0]
    H = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            h = dg[i].d[j] * free[i] * free[j]
            if i == j:
                h = h + (1.0 - free[i]) + LEVENBERG
            H[i][j] = h
    return H


def ldlt_c(H, b):
    """Unrolled LDL^T solve of ``H x = b`` (lower triangle of H read)."""
    n = len(b)
    L = [[None] * n for _ in range(n)]
    D = [None] * n
    for j in range(n):
        d = H[j][j]
        for k in range(j):
            d = d - L[j][k] * L[j][k] * D[k]
        d = torch.where(torch.abs(d) < DIAG_FLOOR, DIAG_FLOOR, d)
        D[j] = d
        for i in range(j + 1, n):
            s = H[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k] * D[k]
            L[i][j] = s / d
    zv = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * zv[k]
        zv[i] = s
    y = [zv[i] / D[i] for i in range(n)]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s
    return x


def rmax(xs):
    return functools.reduce(torch.maximum, xs)


def _solve(H, g, inv_w2):
    """The step ``-H^{-1} g``, or ``-g/w^2`` where it is not finite."""
    n = len(g)
    p = ldlt_c(H, [-g[i] for i in range(n)])
    finite = functools.reduce(torch.logical_and, [torch.isfinite(pi) for pi in p])
    return [torch.where(finite, p[i], -g[i] * inv_w2) for i in range(n)]


def _trial_ok(energy_fn, edet_fn, zt, e0, det_floor):
    e_a = energy_fn(zt)
    return torch.isfinite(e_a) & (e_a <= e0) & (edet_fn(zt) > det_floor)


def _backtrack(zc, p, energy_fn, edet_fn, e0, det_floor):
    """The largest of ``ALPHAS_BT`` whose trial is accepted, 0 if none."""
    alpha = torch.zeros_like(zc[0])
    for a in ALPHAS_BT:
        ok = _trial_ok(energy_fn, edet_fn, [zc[i] + a * p[i] for i in range(len(zc))],
                       e0, det_floor)
        alpha = torch.where(ok, a, alpha)
    return alpha


def _stalled(step_inf, zc):
    """A step no larger than ``eps_stall`` relative to ``1 + max |z|``."""
    return step_inf <= eps_stall(zc[0].dtype) * (1.0 + rmax([torch.abs(zi) for zi in zc]))


def _gnorm(g):
    gnorm = torch.abs(g[0])
    for i in range(1, len(g)):
        gnorm = gnorm + torch.abs(g[i])
    return gnorm


def _stepping_rows(not_first, g, tol, stats):
    """The elements that step in a sweep: all of them in the first sweep;
    from the second on, those whose gradient norm is not below ``tol`` (the
    others retire without moving). Counts the retired ones in
    ``stats["gnorm_retired"]``. Returns ``(rows, count)``, ``rows`` the
    indices of those that step or ``slice(None)`` where all do."""
    go = ~(_gnorm(g) < tol) if not_first else torch.ones_like(g[0], dtype=torch.bool)
    rows = torch.nonzero(go).squeeze(1)
    if stats is not None:
        stats["gnorm_retired"] = stats.get("gnorm_retired", 0) + go.numel() - rows.numel()
    return (slice(None) if rows.numel() == go.numel() else rows), rows.numel()


def _moved(zc, rows, step, stalled):
    """``(z_new, still_active)``: ``zc`` with its rows ``rows`` moved by
    ``step`` and kept active unless ``stalled``; the other rows retire."""
    keep = torch.zeros_like(zc[0], dtype=torch.bool)
    keep[rows] = ~stalled
    z_new = []
    for zi, si in zip(zc, step):
        zi = zi.clone()
        zi[rows] = zi[rows] + si
        z_new.append(zi)
    return z_new, keep


def newton_sweep(not_first, zc, fns, edet_fn, inv_w2, tol, stats=None):
    """One sweep over elements that are all active (``make_newton_sweeps``'s
    ``one_iter``). ``fns(rows) -> (grad_fn, hess_fn, energy_fn)`` gives the
    element functions on the columns ``rows`` of ``zc`` (``slice(None)``
    for all): ``grad_fn(z) -> (grads, ih, e_reg)``, ``hess_fn(z) -> H``,
    ``energy_fn(z) -> e_reg``; ``edet_fn(z)``.

    An element that retires on ``gnorm < tol`` (from the second sweep on)
    does not move, so only the others build a Hessian, solve and try the
    five steps; the JAX kernel computes those for every lane and discards
    them, with the same results. ``stats``, if given, accumulates
    ``hessians`` (elements that built one) and ``gnorm_retired``. Returns
    ``(z_new, still_active)``."""
    g, _, e0 = fns(slice(None))[0](zc)
    rows, count = _stepping_rows(not_first, g, tol, stats)
    if stats is not None:
        stats["hessians"] = stats.get("hessians", 0) + count
    if count == 0:
        return list(zc), torch.zeros_like(e0, dtype=torch.bool)
    _, hess_fn, energy_fn = fns(rows)
    zr = [zi[rows] for zi in zc]
    p = _solve(hess_fn(zr), [gi[rows] for gi in g], inv_w2)
    det_floor = torch.clamp_max(edet_fn(zr), 0.0)
    alpha = _backtrack(zr, p, energy_fn, edet_fn, e0[rows], det_floor)
    stalled = _stalled(alpha * rmax([torch.abs(pi) for pi in p]), zr)
    return _moved(zc, rows, [alpha * pi for pi in p], stalled)


def cols_of(sub, rows):
    """The columns ``rows`` of the columns ``sub`` (each an index tensor or
    ``slice(None)``)."""
    if isinstance(sub, slice):
        return rows
    return sub if isinstance(rows, slice) else sub[rows]


def run_sweeps(z, max_iters, sweep, stats=None, carry=None):
    """Up to ``max_iters`` sweeps of the columns of ``z [n, N]`` that are
    still active; an element's result does not depend on any other
    element, so only those are swept. ``sweep(not_first, sub, zc)`` sweeps
    the columns ``sub`` at ``zc`` and returns ``(z_new, keep)``; with a
    per-element ``carry [m, N]`` (the chord sweep's cached Hessian),
    ``sweep(not_first, sub, zc, carry[:, sub])`` returns ``(z_new, keep,
    carry_new)``. Returns the final ``z``; ``stats``, if given, receives
    ``sweeps`` and ``element_sweeps``."""
    out = z.clone()
    idx = torch.arange(z.shape[1], device=z.device)
    sweeps = element_sweeps = 0
    for it in range(int(max_iters)):
        if idx.numel() == 0:
            break
        sub = idx if idx.numel() < z.shape[1] else slice(None)
        if carry is None:
            z_new, keep = sweep(it > 0, sub, list(out[:, sub]))
        else:
            z_new, keep, carry[:, sub] = sweep(it > 0, sub, list(out[:, sub]), carry[:, sub])
        out[:, sub] = torch.stack(z_new)
        sweeps += 1
        element_sweeps += idx.numel()
        idx = idx[keep]
    if stats is not None:
        stats.update(sweeps=sweeps, element_sweeps=element_sweeps)
    return out


def consts(w: float, dtype=torch.float32):
    """The prox constants ``(w^2, w^2/2, 1/w^2)`` in ``dtype``, as the JAX
    kernels round them."""
    return rnd(w * w, dtype), rnd(0.5 * w * w, dtype), rnd(1.0 / (w * w), dtype)


