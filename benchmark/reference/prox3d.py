"""Plain PyTorch K4, the 3D prox z-update with damped-Newton sweeps and the
constant reference Ehat: a frozen copy of the plain version in
``mmadmm_tpu_torch/ops/prox3d.py`` (``prox3d_plain`` and the element
functions it calls), kept here so that the benchmark's reference and its
work count do not change when the program does.

For every tetrahedron it runs up to ``max_iters`` damped-Newton sweeps on
``I_h(z) + 0.5 w^2 |dxpu - z|^2``, each with the analytic Huang gradient
masked by ``free``, the 12x12 Hessian as the forward derivative of that
gradient, an unrolled LDL^T solve with the ``-g/w^2`` fallback and 5
backtracking trials (``newton.py``). The unregularized energy at the input
z comes out as ``ih0``.

Layout: channel-major ``[C, N]`` tensors, all float32 or all float64:
``z, dxpu, free [12, N]`` (channel ``v*3 + d``) and ``cells [216, N]``:
per vertex, vertex-major, its cell's 8 corners as ``(m00, m01, m02, m11,
m12, m22)`` and then ``x0, x1, y0, y1, z0, z1``.
"""

from __future__ import annotations

import torch

from .newton import (DET_FLOOR, DTYPES, Dual, absolute, cols_of, consts, dtype_of, hessian,
                     max_floor, newton_sweep, rnd, run_sweeps, sqrt)

ROW_W3 = 54  # per vertex: 48 corner entries + x0, x1, y0, y1, z0, z1
_SYM_W = (1.0, 2.0, 2.0, 1.0, 2.0, 1.0)  # contraction weights of the sym pairs

# d = 3, p = 3/2, theta = 1/3 (AdaptationFunctional.cpp:210-220). Python
# floats and their products are rounded to the tile's dtype where they meet
# a tile, as in the JAX kernel (``prox_pallas3d.py:143, :173, :182-184``):
# to f32 in a float32 run, nothing in a float64 one. By dtype: (third,
# third d_dp2, 1.5 third d_dp2, 0.5 third, (0.5 - third)(1 - 1.5) d_dp2).
_D_DP2 = 3.0 ** 2.25  # d^(d p / 2)
_THIRD = 1.0 / 3.0
_K3 = {dt: tuple(rnd(v, dt) for v in (
    _THIRD, _THIRD * _D_DP2, 1.5 * _THIRD * _D_DP2, 0.5 * _THIRD,
    (0.5 - _THIRD) * (1.0 - 1.5) * _D_DP2)) for dt in DTYPES}


def _div(x, c: float):
    """``x / c`` for a Python float c, as an IEEE division: PyTorch turns
    a division of a CUDA tensor by a Python scalar into a multiply by its
    reciprocal, which the kernel does not do."""
    def q(t):
        return t / torch.full((), c, dtype=t.dtype, device=t.device)

    if isinstance(x, Dual):
        return Dual(q(x.v), q(x.d))
    return q(x)


def _sym_to_full(s):
    return [s[0], s[1], s[2], s[1], s[3], s[4], s[2], s[4], s[5]]


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _mm33(A, B):
    """Row-major 9-list product."""
    return [_dot3([A[i * 3 + k] for k in range(3)], [B[k * 3 + j] for k in range(3)])
            for i in range(3) for j in range(3)]


def _det33(A):
    return (A[0] * (A[4] * A[8] - A[5] * A[7])
            - A[1] * (A[3] * A[8] - A[5] * A[6])
            + A[2] * (A[3] * A[7] - A[4] * A[6]))


def _inv33(A, det):
    """Adjugate over det, the cofactor layout of ``huang._inv``."""
    r = 1.0 / det
    return [
        (A[4] * A[8] - A[5] * A[7]) * r, (A[2] * A[7] - A[1] * A[8]) * r,
        (A[1] * A[5] - A[2] * A[4]) * r, (A[5] * A[6] - A[3] * A[8]) * r,
        (A[0] * A[8] - A[2] * A[6]) * r, (A[2] * A[3] - A[0] * A[5]) * r,
        (A[3] * A[7] - A[4] * A[6]) * r, (A[1] * A[6] - A[0] * A[7]) * r,
        (A[0] * A[4] - A[1] * A[3]) * r,
    ]


def _sample_m3(cell, x, y, z):
    """Trilinear monitor sample ``(m00, m01, m02, m11, m12, m22)`` from
    one vertex's 54 cell channels."""
    xd = (x - cell[48]) / (cell[49] - cell[48])
    yd = (y - cell[50]) / (cell[51] - cell[50])
    zd = (z - cell[52]) / (cell[53] - cell[52])
    wts = [
        (1 - xd) * (1 - yd) * (1 - zd), xd * (1 - yd) * (1 - zd),
        (1 - xd) * yd * (1 - zd), xd * yd * (1 - zd),
        (1 - xd) * (1 - yd) * zd, xd * (1 - yd) * zd,
        (1 - xd) * yd * zd, xd * yd * zd,
    ]
    out = []
    for e in range(6):
        s = wts[0] * cell[e]
        for c in range(1, 8):
            s = s + wts[c] * cell[c * 6 + e]
        out.append(s)
    return out


def _q225(t):
    """t^2.25 as t t t^(1/4)."""
    return t * t * sqrt(sqrt(t))


def _q125(t):
    return t * sqrt(sqrt(t))


def _common_c3(z, cells, ehat):
    """Terms shared by energy and gradient. ``z``: 12 channels
    (vertex-major); ``cells``: 4 lists of 54 channels; ``ehat``: 9 floats
    (row-major 3x3), or 9 channels (one Ehat per element)."""
    m = [_sample_m3(cells[v], z[3 * v], z[3 * v + 1], z[3 * v + 2]) for v in range(4)]
    ms_full = _sym_to_full([m[0][e] + m[1][e] + m[2][e] + m[3][e] for e in range(6)])
    mi = [v * 0.25 for v in _inv33(ms_full, _det33(ms_full))]  # inv(m_sum) / (D+1)

    E = [z[3 * (j + 1) + d] - z[d] for d in range(3) for j in range(3)]  # E[d][j]
    edet = _det33(E)
    ei = _inv33(E, edet)
    fj = _mm33(ehat, ei)
    det_fj = _det33(fj)

    mj = [_dot3(mi[3 * a:3 * a + 3], fj[3 * b:3 * b + 3])  # minv @ fj^T
          for a in range(3) for b in range(3)]
    tr = fj[0] * mj[0]
    for i in range(3):
        for j in range(3):
            if i or j:
                tr = tr + fj[i * 3 + j] * mj[j * 3 + i]

    det_m = sqrt(1.0 / max_floor(_det33(mi), DET_FLOOR))
    tr_c = max_floor(tr, DET_FLOOR)
    det_fj_c = max_floor(det_fj, DET_FLOOR)
    inv_sqrt_dm = 1.0 / sqrt(det_m)
    sqrt_dfj = sqrt(det_fj_c)
    dfj32 = det_fj_c * sqrt_dfj
    k_third, k_g2 = _K3[dtype_of(z[0])][:2]
    G = k_third * det_m * _q225(tr_c) + k_g2 * dfj32 * inv_sqrt_dm
    return dict(m=m, mi=mi, ei=ei, fj=fj, mj=mj, tr=tr_c, det_m=det_m, det_fj=det_fj_c,
                G=G, abs_k=absolute(_div(edet, 6.0)), inv_sqrt_dm=inv_sqrt_dm,
                sqrt_dfj=sqrt_dfj, dfj32=dfj32)


def _reg(z, dxpu):
    """``sum_i (dxpu_i - z_i)^2`` in channel order."""
    d = dxpu[0] - z[0]
    s = d * d
    for i in range(1, 12):
        d = dxpu[i] - z[i]
        s = s + d * d
    return s


def energy_c3(z, cells, ehat, dxpu=None, half_w2=None):
    """``(ih_unregularized, e_regularized)``."""
    t = _common_c3(z, cells, ehat)
    ih = t["abs_k"] * t["G"]
    if dxpu is None:
        return ih, ih
    return ih, ih + half_w2 * _reg(z, dxpu)


def grad_c3(z, cells, ehat, dxpu, w2, half_w2, free):
    """``(grads[12], ih_unreg, e_reg)``; the reference's analytic gradient
    (``AdaptationFunctional.cpp:232-271``) plus the prox term, masked by
    ``free``."""
    t = _common_c3(z, cells, ehat)
    G, det_m, tr, det_fj = t["G"], t["det_m"], t["tr"], t["det_fj"]
    mi, ei, fj, mj = t["mi"], t["ei"], t["fj"], t["mj"]
    k_dgddet, k_sm2a, k_sm2b = _K3[dtype_of(z[0])][2:]

    s_j = 1.5 * det_m * _q125(tr)  # dGdJ = d p theta det_m tr^(dp2-1) minv_jt
    dj = [s_j * v for v in mj]
    dgddet = k_dgddet * t["inv_sqrt_dm"] * t["sqrt_dfj"]

    A = _mm33(fj, mi)  # B = (fj minv)^T (fj minv)
    B = [_dot3([A[i], A[3 + i], A[6 + i]], [A[j], A[3 + j], A[6 + j]])
         for i in range(3) for j in range(3)]
    s_m1 = -0.5 * s_j
    s_m2 = k_sm2a * det_m * _q225(tr) + (k_sm2b * t["inv_sqrt_dm"] * t["dfj32"])
    dgdm = [s_m1 * B[i] + s_m2 * mi[i] for i in range(9)]
    dgdm_sym = [dgdm[0], dgdm[1], dgdm[2], dgdm[4], dgdm[5], dgdm[8]]

    m = t["m"]
    traces = []
    for j in range(3):
        dm = [m[j + 1][e] - m[0][e] for e in range(6)]
        s = _SYM_W[0] * dm[0] * dgdm_sym[0]
        for e in range(1, 6):
            s = s + _SYM_W[e] * dm[e] * dgdm_sym[e]
        traces.append(s)
    bc = [_dot3(traces, [ei[k], ei[3 + k], ei[6 + k]]) for k in range(3)]

    c1 = -G + dgddet * det_fj
    qf = _mm33(_mm33(ei, dj), fj)
    v_loc = [c1 * ei[j * 3 + k] + qf[j * 3 + k] - bc[k] * 0.25
             for j in range(3) for k in range(3)]

    abs_k = t["abs_k"]
    grads = [(v_loc[k] + v_loc[3 + k] + v_loc[6 + k] + bc[k]) * abs_k for k in range(3)]
    grads += [-v_loc[i] * abs_k for i in range(9)]
    ih = abs_k * G
    e_reg = ih + half_w2 * _reg(z, dxpu)
    grads = [(grads[i] + w2 * (z[i] - dxpu[i])) * free[i] for i in range(12)]
    return grads, ih, e_reg


def hess_c3(z, cells, ehat, dxpu, w2, half_w2, free):
    """Lower triangle ``H[i][j]`` (i >= j) of the 12x12 derivative of
    ``grad_c3`` (``hess_c3``, ``prox_pallas3d.py:230-250``)."""
    return hessian(lambda zz: grad_c3(zz, cells, ehat, dxpu, w2, half_w2, free), z, free)


def edet_c3(z):
    E = [z[3 * (j + 1) + d] - z[d] for d in range(3) for j in range(3)]
    return _det33(E)


def _rows(cells):
    return [[cells[v * ROW_W3 + k] for k in range(ROW_W3)] for v in range(4)]


def _ehat_of(ehat):
    """``ehat_of(cols)``: the Ehat of the columns ``cols``, the 9 constant
    floats of a 9-float ``ehat``, or the columns of the channels ``[9, N]``."""
    if isinstance(ehat, torch.Tensor) and ehat.dim() == 2:
        return lambda cols: list(ehat[:, cols])
    const = tuple(float(v) for v in ehat)
    return lambda cols: const


def _element_fns(dxpu, free, cells, ehat_of, w2, half_w2):
    """``fns(cols) -> (grad_fn, hess_fn, energy_fn)``: the element
    functions on the columns ``cols``."""
    def fns(cols):
        d, fr, c, eh = (list(dxpu[:, cols]), list(free[:, cols]), _rows(cells[:, cols]),
                        ehat_of(cols))
        return (lambda zz: grad_c3(zz, c, eh, d, w2, half_w2, fr),
                lambda zz: hess_c3(zz, c, eh, d, w2, half_w2, fr),
                lambda zz: energy_c3(zz, c, eh, d, half_w2)[1])
    return fns


def _newton_plain(z, dxpu, free, cells, ehat_of, w, tol, max_iters, stats):
    """Up to ``max_iters`` Newton sweeps of the elements still active."""
    w2, half_w2, inv_w2 = consts(w, z.dtype)
    tol = rnd(tol, z.dtype)
    ih0, _ = energy_c3(list(z), _rows(cells), ehat_of(slice(None)))
    fns = _element_fns(dxpu, free, cells, ehat_of, w2, half_w2)

    def sweep(not_first, sub, zc):
        return newton_sweep(not_first, zc, lambda rows: fns(cols_of(sub, rows)), edet_c3, inv_w2,
                            tol, stats)

    return run_sweeps(z, max_iters, sweep, stats), ih0


def prox3d_plain(z, dxpu, free, cells, ehat, w, tol, max_iters, stats=None):
    """Plain PyTorch K4 on ``[C, N]`` channel tensors, sweeping only the
    elements still active. Returns ``(z_out [12, N], ih0 [N])``;
    ``stats``, if given, receives ``sweeps``, ``element_sweeps``,
    ``hessians`` and ``gnorm_retired`` (``newton.py::newton_sweep``)."""
    return _newton_plain(z, dxpu, free, cells, _ehat_of(ehat), w, tol, max_iters, stats)


