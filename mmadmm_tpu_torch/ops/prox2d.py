"""The 2D ADMM prox z-update: kernel K1 and its plain PyTorch version.

Port of ``mmadmm_tpu/ops/prox_pallas2d.py::make_prox_pallas2d`` (the
component-form Pallas kernel, ``_make_kernel`` and ``newton_sweeps_c``).
For every triangle it runs up to ``max_iters`` damped-Newton sweeps on
``I_h(z) + 0.5 w^2 |dxpu - z|^2``. Each sweep takes

* the analytic Huang gradient (``grad_c``), masked by ``free``,
* the 6x6 Hessian as the forward derivative of that gradient, with
  identity plus a 1e-9 Levenberg term on fixed coordinates (``hess_c``),
* an unrolled LDL^T solve (``ldlt_c``), replaced by ``-g/w^2`` where the
  result is not finite,
* 5 backtracking trials, alpha 1/16 to 1, that need a finite energy not
  above the start and ``edet > min(det0, 0)``.

An element retires on ``gnorm < tol`` from the second sweep on, or when its
step stalls. The unregularized energy at the input z comes out as ``ih0``.

Layout: channel-major ``[C, N]`` tensors, float32 or float64 (the JAX
kernel's ``[C, T, 8, 128]`` tiles are the same memory as ``[C, T*1024]``),
the kernel and its constants in the tensors' dtype:
``z, dxpu, free [6, N]`` (channel ``v*2 + d``), ``cells [48, N]`` (three
16-wide cell-table rows, vertex-major).

``prox2d`` is the entry point on channel tensors, ``prox_elements`` the
element-major one of the stock engine. On a CPU tensor they run
``prox2d_plain``; on a CUDA tensor they launch the CUDA kernel
``csrc/prox2d.cu`` built in the tensors' dtype (``mm_prox2d`` in float32,
``mm_prox2d_f64`` in float64) or raise. The plain version repeats the
kernel's arithmetic operation by operation (the Hessian through the same
forward-mode dual numbers), so the kernel built with ``--fmad=false`` can
agree with it bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..cuda_build import load_library
from .monitor_grid import element_cell_rows
from .newton import (DET_FLOOR, DTYPES, absolute, cols_of, count_launch, dtype_of, hessian,
                     ldlt_c, max_floor, newton_sweep, rnd, run_sweeps, sqrt)
from .newton import check as _check
from .newton import consts as _consts

ROW_W = 16


def _k2(np_t):
    """The kernel's constants in the NumPy type ``np_t``, rounded exactly as
    the JAX kernel rounds them in that dtype: a Python float (or a product
    of Python floats) that meets a tile is cast to the tile's dtype first,
    and ``c_d32 = 2 sqrt(2)`` is computed in it. Returns ``(third, third *
    c_d32, 1.5 third c_d32, 0.5 third, (0.5 - third)(1 - 1.5) c_d32)``."""
    c_d32 = np_t(2.0) * np.sqrt(np_t(2.0))  # 2^1.5
    return (float(np_t(1.0 / 3.0)), float(np_t(1.0 / 3.0) * c_d32),
            float(np_t(1.5 * (1.0 / 3.0)) * c_d32), float(np_t(0.5 * (1.0 / 3.0))),
            float(np_t((0.5 - 1.0 / 3.0) * (1.0 - 1.5)) * c_d32))


_K2 = {dt: _k2(np_t) for dt, np_t in DTYPES.items()}


def _sample_m(cell, x, y):
    """Bilinear monitor sample ``(m00, m01, m11)`` from one vertex's 16
    cell-row channels."""
    x0, x1, y0, y1 = cell[12], cell[13], cell[14], cell[15]
    norm = 1.0 / ((x1 - x0) * (y1 - y0))
    c00 = norm * (x1 - x) * (y1 - y)
    c10 = norm * (x - x0) * (y1 - y)
    c01 = norm * (x1 - x) * (y - y0)
    c11 = norm * (x - x0) * (y - y0)

    def entry(k):
        return (c00 * cell[0 + k] + c10 * cell[3 + k]
                + c01 * cell[6 + k] + c11 * cell[9 + k])

    return entry(0), entry(1), entry(2)


def _common_c(z, cells, ehat):
    """Terms shared by energy and gradient. ``z``: 6 channels
    (v0x, v0y, v1x, v1y, v2x, v2y); ``cells``: 3 lists of 16 channels;
    ``ehat``: 4 floats (row-major 2x2)."""
    m = [_sample_m(cells[v], z[2 * v], z[2 * v + 1]) for v in range(3)]
    ms00 = m[0][0] + m[1][0] + m[2][0]
    ms01 = m[0][1] + m[1][1] + m[2][1]
    ms11 = m[0][2] + m[1][2] + m[2][2]
    det_ms = ms00 * ms11 - ms01 * ms01
    q = 1.0 / (3.0 * det_ms)  # minv = inv(m_sum) / 3
    mi00 = ms11 * q
    mi01 = -ms01 * q
    mi11 = ms00 * q

    e00 = z[2] - z[0]
    e10 = z[3] - z[1]
    e01 = z[4] - z[0]
    e11 = z[5] - z[1]
    edet = e00 * e11 - e01 * e10
    r = 1.0 / edet
    ei00 = e11 * r
    ei01 = -e01 * r
    ei10 = -e10 * r
    ei11 = e00 * r

    h00, h01, h10, h11 = ehat
    fj00 = h00 * ei00 + h01 * ei10
    fj01 = h00 * ei01 + h01 * ei11
    fj10 = h10 * ei00 + h11 * ei10
    fj11 = h10 * ei01 + h11 * ei11
    det_fj = fj00 * fj11 - fj01 * fj10

    mj00 = mi00 * fj00 + mi01 * fj01  # minv @ fj^T
    mj01 = mi00 * fj10 + mi01 * fj11
    mj10 = mi01 * fj00 + mi11 * fj01
    mj11 = mi01 * fj10 + mi11 * fj11
    tr = fj00 * mj00 + fj01 * mj10 + fj10 * mj01 + fj11 * mj11

    det_minv = mi00 * mi11 - mi01 * mi01
    det_m = sqrt(1.0 / max_floor(det_minv, DET_FLOOR))
    tr_c = max_floor(tr, DET_FLOOR)
    det_fj_c = max_floor(det_fj, DET_FLOOR)

    sqrt_tr = sqrt(tr_c)
    tr32 = tr_c * sqrt_tr
    sqrt_dfj = sqrt(det_fj_c)
    dfj32 = det_fj_c * sqrt_dfj
    inv_sqrt_dm = 1.0 / sqrt(det_m)
    third, k_g2 = _K2[dtype_of(z[0])][:2]
    G = third * det_m * tr32 + k_g2 * dfj32 * inv_sqrt_dm
    abs_k = absolute(edet * 0.5)
    return dict(
        m=m, mi00=mi00, mi01=mi01, mi11=mi11,
        ei00=ei00, ei01=ei01, ei10=ei10, ei11=ei11,
        fj00=fj00, fj01=fj01, fj10=fj10, fj11=fj11,
        mj00=mj00, mj01=mj01, mj10=mj10, mj11=mj11,
        tr=tr_c, det_m=det_m, det_fj=det_fj_c, G=G, abs_k=abs_k,
        sqrt_tr=sqrt_tr, sqrt_dfj=sqrt_dfj, inv_sqrt_dm=inv_sqrt_dm,
    )


def energy_c(z, cells, ehat, dxpu=None, half_w2=None):
    """``(ih_unregularized, e_regularized)``."""
    t = _common_c(z, cells, ehat)
    ih = t["abs_k"] * t["G"]
    if dxpu is None:
        return ih, ih
    reg = (dxpu[0] - z[0]) * (dxpu[0] - z[0])
    for i in range(1, 6):
        reg = reg + (dxpu[i] - z[i]) * (dxpu[i] - z[i])
    return ih, ih + half_w2 * reg


def grad_c(z, cells, ehat, dxpu, w2, half_w2, free):
    """``(grads[6], ih_unreg, e_reg)``; the gradient is the reference's
    analytic one (``AdaptationFunctional.cpp:232-271``) plus the prox
    term, masked by ``free``."""
    t = _common_c(z, cells, ehat)
    G, det_m, tr, det_fj = t["G"], t["det_m"], t["tr"], t["det_fj"]
    sqrt_tr, sqrt_dfj = t["sqrt_tr"], t["sqrt_dfj"]
    mi00, mi01, mi11 = t["mi00"], t["mi01"], t["mi11"]
    fj00, fj01, fj10, fj11 = t["fj00"], t["fj01"], t["fj10"], t["fj11"]
    mj00, mj01, mj10, mj11 = t["mj00"], t["mj01"], t["mj10"], t["mj11"]
    ei00, ei01, ei10, ei11 = t["ei00"], t["ei01"], t["ei10"], t["ei11"]
    third, _, k_dgddet, k_sm2a, k_sm2b = _K2[dtype_of(z[0])]

    s_j = det_m * sqrt_tr  # dGdJ = det_m tr^(1/2) minv_jt
    dj00 = s_j * mj00
    dj01 = s_j * mj01
    dj10 = s_j * mj10
    dj11 = s_j * mj11
    dgddet = k_dgddet * t["inv_sqrt_dm"] * sqrt_dfj

    a00 = fj00 * mi00 + fj01 * mi01  # A = fj minv
    a01 = fj00 * mi01 + fj01 * mi11
    a10 = fj10 * mi00 + fj11 * mi01
    a11 = fj10 * mi01 + fj11 * mi11
    b00 = a00 * a00 + a10 * a10  # B = A^T A
    b01 = a00 * a01 + a10 * a11
    b11 = a01 * a01 + a11 * a11
    s_m1 = -0.5 * s_j
    tr32 = tr * sqrt_tr
    dfj32 = det_fj * sqrt_dfj
    s_m2 = k_sm2a * det_m * tr32 + (k_sm2b * t["inv_sqrt_dm"] * dfj32)
    dm00 = s_m1 * b00 + s_m2 * mi00  # dGdM (symmetric)
    dm01 = s_m1 * b01 + s_m2 * mi01
    dm11 = s_m1 * b11 + s_m2 * mi11

    m = t["m"]
    d1 = (m[1][0] - m[0][0], m[1][1] - m[0][1], m[1][2] - m[0][2])
    d2 = (m[2][0] - m[0][0], m[2][1] - m[0][1], m[2][2] - m[0][2])
    tr1 = d1[0] * dm00 + 2.0 * d1[1] * dm01 + d1[2] * dm11
    tr2 = d2[0] * dm00 + 2.0 * d2[1] * dm01 + d2[2] * dm11
    bc0 = tr1 * ei00 + tr2 * ei10
    bc1 = tr1 * ei01 + tr2 * ei11

    c1 = -G + dgddet * det_fj
    q00 = ei00 * dj00 + ei01 * dj10  # C = einv dGdJ
    q01 = ei00 * dj01 + ei01 * dj11
    q10 = ei10 * dj00 + ei11 * dj10
    q11 = ei10 * dj01 + ei11 * dj11
    v00 = c1 * ei00 + q00 * fj00 + q01 * fj10 - bc0 * third
    v01 = c1 * ei01 + q00 * fj01 + q01 * fj11 - bc1 * third
    v10 = c1 * ei10 + q10 * fj00 + q11 * fj10 - bc0 * third
    v11 = c1 * ei11 + q10 * fj01 + q11 * fj11 - bc1 * third

    g0x = v00 + v10 + bc0
    g0y = v01 + v11 + bc1
    abs_k = t["abs_k"]
    grads = [g0x * abs_k, g0y * abs_k, -v00 * abs_k, -v01 * abs_k,
             -v10 * abs_k, -v11 * abs_k]
    ih = abs_k * G
    reg = (dxpu[0] - z[0]) * (dxpu[0] - z[0])
    for i in range(1, 6):
        reg = reg + (dxpu[i] - z[i]) * (dxpu[i] - z[i])
    e_reg = ih + half_w2 * reg
    grads = [(grads[i] + w2 * (z[i] - dxpu[i])) * free[i] for i in range(6)]
    return grads, ih, e_reg


def hess_c(z, cells, ehat, dxpu, w2, half_w2, free):
    """Lower triangle ``H[i][j]`` (i >= j) of the 6x6 derivative of
    ``grad_c``, from one dual pass carrying all 6 directions. Fixed
    coordinates get identity rows and columns, and every diagonal the
    Levenberg term."""
    return hessian(lambda zz: grad_c(zz, cells, ehat, dxpu, w2, half_w2, free), z, free)


def _edet_c(z):
    return (z[2] - z[0]) * (z[5] - z[1]) - (z[4] - z[0]) * (z[3] - z[1])


def prox2d_plain(z, dxpu, free, cells, ehat, w, tol, max_iters, stats=None):
    """Plain PyTorch K1 on ``[C, N]`` channel tensors. Sweeps only the
    elements still active (an element's result does not depend on any
    other element). Returns ``(z_out [6, N], ih0 [N])``; ``stats``, if
    given, receives ``sweeps``, ``element_sweeps``, ``hessians`` and
    ``gnorm_retired`` (``ops/newton.py::newton_sweep``)."""
    ehat = tuple(float(v) for v in ehat)
    w2, half_w2, inv_w2 = _consts(w, z.dtype)
    tol = rnd(tol, z.dtype)

    def rows(c):
        return [[c[v * ROW_W + k] for k in range(ROW_W)] for v in range(3)]

    ih0, _ = energy_c(list(z), rows(cells), ehat)

    def fns(cols):
        d, fr, c = list(dxpu[:, cols]), list(free[:, cols]), rows(cells[:, cols])
        return (lambda zz: grad_c(zz, c, ehat, d, w2, half_w2, fr),
                lambda zz: hess_c(zz, c, ehat, d, w2, half_w2, fr),
                lambda zz: energy_c(zz, c, ehat, d, half_w2)[1])

    def sweep(not_first, sub, zc):
        return newton_sweep(not_first, zc, lambda r: fns(cols_of(sub, r)), _edet_c, inv_w2, tol,
                            stats)

    return run_sweeps(z, max_iters, sweep, stats), ih0


def prox2d(z, dxpu, free, cells, ehat, w, tol, max_iters):
    """K1: the prox z-update on ``[C, N]`` channel tensors, all float32
    or all float64.

    A CPU tensor goes to ``prox2d_plain``. A CUDA tensor launches the
    kernel from ``csrc/prox2d.cu`` built in its dtype on the current stream
    (built at first use) and counts the launch in ``prox2d.launches``
    (float32) or ``prox2d.launches_f64`` (float64)."""
    n = z.shape[1]
    for name, t, rows in (("z", z, 6), ("dxpu", dxpu, 6), ("free", free, 6),
                          ("cells", cells, 3 * ROW_W)):
        _check(name, t, rows, n, z.device, z.dtype)
    if z.device.type == "cpu":
        return prox2d_plain(z, dxpu, free, cells, ehat, w, tol, max_iters)
    if z.device.type != "cuda":
        raise ValueError(f"prox2d runs on cpu or cuda, not {z.device}")
    lib = library()
    zout = torch.empty_like(z)
    ih0 = torch.empty(n, dtype=z.dtype, device=z.device)
    w2, half_w2, inv_w2 = _consts(w, z.dtype)
    h = [float(v) for v in ehat]
    stream = torch.cuda.current_stream(z.device).cuda_stream
    rc = (lib.mm_prox2d_f64 if z.dtype == torch.float64 else lib.mm_prox2d)(
        z.data_ptr(), dxpu.data_ptr(), free.data_ptr(), cells.data_ptr(),
        zout.data_ptr(), ih0.data_ptr(), n, h[0], h[1], h[2], h[3],
        w2, half_w2, inv_w2, rnd(tol, z.dtype), int(max_iters), stream,
    )
    if rc != 0:
        raise RuntimeError(f"prox2d kernel launch failed: CUDA error {rc}")
    count_launch(prox2d, z.dtype)
    return zout, ih0


prox2d.launches = prox2d.launches_f64 = 0


def prox_elements(grid, z, dxpu, free, ehat, w, tol, max_iters):
    """K1's element-major entry, for the stock engine
    (``prox_pallas2d.py:698-721``): ``z, dxpu, free [NF, 3, 2]`` to
    channels, the 48-channel cell fetch at z, ``prox2d``, and back.
    Returns ``(z' [NF, 3, 2], ih0 [NF])``."""
    nf = z.shape[0]

    def ch(a):
        return a.reshape(nf, 6).T.contiguous()

    zo, ih0 = prox2d(ch(z), ch(dxpu), ch(free), element_cell_rows(grid, z), ehat, w, tol,
                     max_iters)
    return zo.T.reshape(nf, 3, 2), ih0

# mm_prox2d and mm_prox2d_f64(z, dxpu, free, cells, zout, ih0, n, h00, h01,
# h10, h11, w2, half_w2, inv_w2, tol, max_iters, stream) in csrc/prox2d.cu,
# the eight constants in float and in double
_SIGNATURES = {name: (
    [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [real] * 8 + [ctypes.c_int, ctypes.c_void_p],
    ctypes.c_int,
) for name, real in (("mm_prox2d", ctypes.c_float), ("mm_prox2d_f64", ctypes.c_double))}
# mm_prox2d_block(f64, shape[3])
_SIGNATURES["mm_prox2d_block"] = ([ctypes.c_int, ctypes.POINTER(ctypes.c_int)], None)


def library() -> ctypes.CDLL:
    """K1's library, built from ``csrc/prox2d.cu`` at first use."""
    return load_library("prox2d", _SIGNATURES)


def block_shape(dtype) -> tuple:
    """``(elements, Hessian columns a dual pass, triangle in registers)`` of
    the block K1 launches with in ``dtype`` (float32 or float64), one thread
    an element, from the built library. The third is 1 where the passes run
    unrolled into a triangle in registers, 0 where they run one by one into
    the element's triangle in shared memory."""
    shape = (ctypes.c_int * 3)()
    library().mm_prox2d_block(int(dtype == torch.float64), shape)
    return tuple(shape)
