"""Frozen copy of ``mmadmm_tpu_torch/ops/huang.py`` for the benchmark's reference.

Huang mesh-adaptation functional: per-element energy and gradient,
batched over elements (port of ``mmadmm_tpu/ops/huang.py``, D = 2 or 3;
reference ``src/AdaptationFunctional.cpp:103-287``).

Per element with stacked vertex coordinates ``z [D+1, D]``:

  mPre_i = M(z_i) sampled from the frozen monitor cells   (:143-153)
  Minv   = (sum_i mPre_i)^{-1} / (D+1)                    (:157)
  E      = [z_1 - z_0, ..., z_D - z_0] (columns)          (:163-169)
  FJ     = Ehat E^{-1}, detFJ = det(FJ)                   (:206-207)
           (Ehat the constant reference one, or per element on a
            computational mesh: E of its xi-mesh vertices, :176-201)
  G      = theta sqrt(det M) tr(FJ Minv FJ^T)^{dp/2}
           + (1-2 theta) d^{dp/2} sqrt(det M) (detFJ/sqrt(det M))^p
  Ih     = |det E| / D! * G                               (:222, :274)

The gradient is the reference's hand-derived formula (:232-271), not the
autodiff gradient of the sampled energy. ``detFJ`` and the trace are
clamped to a tiny positive floor so fractional powers never see a
negative base. Small matrix products are written out as broadcast sums.

The fractional powers (``_pow``) are square roots and products, as the
prox kernels write them: PyTorch's CPU ``pow`` rounds differently in its
vectorized and scalar loops, so an element's value would depend on its
place in the batch (and on how the batch is cut into slabs); its square
root, and every derivative of these forms, does not.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .monitor_grid import sample_frozen

P_EXP = 1.5  # AdaptationFunctional.cpp:210
THETA = 1.0 / 3.0  # :211
_DET_FLOOR = 1e-30


def d_factorial(D: int) -> float:
    return 2.0 if D == 2 else 6.0  # :128-132


def reference_ehat(D: int, n_elements: int) -> np.ndarray:
    """The constant reference edge matrix (:176-201), float64: a fixed
    simplex edge matrix normalized to |det| = D!, scaled by N^{-1/D}."""
    if D == 2:
        base = np.array([[1.0, 0.5], [0.0, math.sqrt(3.0) / 2.0]])
    else:
        base = np.array([[-2.0, 0.0, -2.0], [0.0, -2.0, -2.0], [-2.0, -2.0, 0.0]])
    det = abs(float(_det(torch.from_numpy(base))))  # exact for these entries
    base = base * (d_factorial(D) / det) ** (1.0 / D)
    return base / float(n_elements) ** (1.0 / D)


def _pow(t, p: float):
    """``t ** p`` for the functional's exponents, from square roots."""
    if p == 0.5:
        return torch.sqrt(t)
    if p == -0.5:
        return 1.0 / torch.sqrt(t)
    if p == 1.5:
        return t * torch.sqrt(t)
    if p == 1.25:
        return t * torch.sqrt(torch.sqrt(t))
    if p == 2.25:
        return t * t * torch.sqrt(torch.sqrt(t))
    raise ValueError(f"no square-root form for the exponent {p}")


def _mm(A, B):
    """C[..., i, j] = sum_k A[..., i, k] B[..., k, j]."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _det(A):
    if A.shape[-1] == 2:
        return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    return (
        A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
        - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
        + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    )


def _inv(A, det=None):
    """Adjugate over determinant, the cofactor layout of the JAX package."""
    if det is None:
        det = _det(A)
    if A.shape[-1] == 2:
        rows = [[A[..., 1, 1], -A[..., 0, 1]], [-A[..., 1, 0], A[..., 0, 0]]]
    else:
        def cof(a, b, c, d):  # A[a] * A[b] - A[c] * A[d]
            return A[..., a[0], a[1]] * A[..., b[0], b[1]] - A[..., c[0], c[1]] * A[..., d[0], d[1]]

        rows = [
            [cof((1, 1), (2, 2), (1, 2), (2, 1)), cof((0, 2), (2, 1), (0, 1), (2, 2)),
             cof((0, 1), (1, 2), (0, 2), (1, 1))],
            [cof((1, 2), (2, 0), (1, 0), (2, 2)), cof((0, 0), (2, 2), (0, 2), (2, 0)),
             cof((0, 2), (1, 0), (0, 0), (1, 2))],
            [cof((1, 0), (2, 1), (1, 1), (2, 0)), cof((0, 1), (2, 0), (0, 0), (2, 1)),
             cof((0, 0), (1, 1), (0, 1), (1, 0))],
        ]
    adj = torch.stack([torch.stack(r, -1) for r in rows], -2)
    return adj / det[..., None, None]


def _common_terms(z, cells, ehat):
    """Shared between energy and gradient. ``z [NF, D+1, D]``, ``cells``
    from ``gather_cell`` over ``[NF, D+1]``, ``ehat`` the constant
    ``[D, D]`` or one per element ``[NF, D, D]`` (both broadcast in
    ``_mm``)."""
    D = z.shape[-1]
    d = float(D)
    m_pre = sample_frozen(cells, z)  # [NF, D+1, D, D]
    m_sum = m_pre.sum(1)
    minv = _inv(m_sum) / (d + 1.0)  # :157 (verbatim, incl. the 1/(D+1))

    E = (z[:, 1:] - z[:, :1]).transpose(-1, -2)  # columns are edges
    edet = _det(E)
    einv = _inv(E, edet)
    fj = _mm(ehat, einv)  # :206
    det_fj = _det(fj)

    fjt = fj.transpose(-1, -2)
    minv_jt = _mm(minv, fjt)
    tr = (fj * minv_jt.transpose(-1, -2)).sum((-2, -1))
    det_m = torch.sqrt(1.0 / torch.clamp_min(_det(minv), _DET_FLOOR))  # :217

    tr_c = torch.clamp_min(tr, _DET_FLOOR)
    det_fj_c = torch.clamp_min(det_fj, _DET_FLOOR)

    dp2 = d * P_EXP / 2.0
    G = THETA * det_m * _pow(tr_c, dp2) + (1.0 - 2.0 * THETA) * d**dp2 * det_m * _pow(
        det_fj_c / det_m, P_EXP
    )  # :219-220
    abs_k = torch.abs(edet / d_factorial(D))  # :222
    return dict(
        m_pre=m_pre, minv=minv, einv=einv, fj=fj, fjt=fjt, minv_jt=minv_jt,
        tr=tr_c, det_m=det_m, det_fj=det_fj_c, G=G, abs_k=abs_k, d=d, dp2=dp2,
    )


def element_energy(z, cells, ehat, dxpu=None, w=None):
    """Ih per element ``[NF]`` (:224-229); plus the prox regularization
    ``0.5 w^2 |dxpu - z|^2`` when ``dxpu`` is given."""
    t = _common_terms(z, cells, ehat)
    ih = t["abs_k"] * t["G"]
    if dxpu is not None:
        ih = ih + 0.5 * w * w * ((dxpu - z) ** 2).sum((-2, -1))
    return ih


def element_energy_grad(z, cells, ehat, dxpu=None, w=None):
    """``(Ih [NF], grad [NF, D+1, D])``, the reference's analytic gradient
    (:232-282). Ih is unregularized; the gradient carries the prox term
    when ``dxpu`` is given."""
    t = _common_terms(z, cells, ehat)
    d, dp2 = t["d"], t["dp2"]
    G, det_m, tr, det_fj = t["G"], t["det_m"], t["tr"], t["det_fj"]
    minv, einv, fj, fjt, minv_jt = (
        t["minv"], t["einv"], t["fj"], t["fjt"], t["minv_jt"]
    )
    m_pre = t["m_pre"]

    def s(a):  # per-element scalar -> broadcast over [D, D]
        return a[..., None, None]

    dGdJ = s(d * P_EXP * THETA * det_m * _pow(tr, dp2 - 1.0)) * minv_jt  # :232
    dGddet = (
        P_EXP * (1.0 - 2.0 * THETA) * d**dp2 * _pow(det_m, 1.0 - P_EXP)
        * _pow(det_fj, P_EXP - 1.0)
    )  # :233
    dGdM = s(
        -0.5 * THETA * d * P_EXP * det_m * _pow(tr, dp2 - 1.0)
    ) * _mm(_mm(minv.transpose(-1, -2), fjt), _mm(fj, minv)) + s(
        0.5 * THETA * det_m * _pow(tr, dp2)
        + (0.5 - THETA) * (1.0 - P_EXP) * d**dp2
        * _pow(det_m, 1.0 - P_EXP) * _pow(det_fj, P_EXP)
    ) * minv  # :234-236

    # basisComb = sum_j einv.row(j) * tr(dGdM (mPre_{j+1} - mPre_0)) (:239-244)
    dm = m_pre[:, 1:] - m_pre[:, :1]  # [NF, D, D, D]
    traces = (dm * dGdM.transpose(-1, -2)[:, None]).sum((-2, -1))  # [NF, D]
    basis_comb = (traces[..., None] * einv).sum(-2)  # traces @ einv

    c1 = -G + dGddet * det_fj  # :246
    v_loc = s(c1) * einv + _mm(_mm(einv, dGdJ), fj)  # :247
    v_loc = v_loc - basis_comb[:, None, :] / (d + 1.0)  # :248-250

    grad_simplex = v_loc.sum(-2) + basis_comb  # :253-258 (dGdX = 0)
    grad = torch.cat([grad_simplex[:, None, :], -v_loc], dim=1)  # :261-269
    grad = grad * s(t["abs_k"])  # :271

    ih = t["abs_k"] * G  # Igt (:274-276)
    if dxpu is not None:
        grad = grad + w * w * (z - dxpu)  # :281
    return ih, grad
