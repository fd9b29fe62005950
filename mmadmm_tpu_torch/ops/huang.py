"""Huang mesh-adaptation functional: per-element energy and gradient,
batched over elements (port of ``mmadmm_tpu/ops/huang.py``, 2D, no
computational mesh; reference ``src/AdaptationFunctional.cpp:103-287``).

Per element with stacked vertex coordinates ``z [3, 2]``:

  mPre_i = M(z_i) sampled from the frozen monitor cells   (:143-153)
  Minv   = (sum_i mPre_i)^{-1} / 3                        (:157)
  E      = [z_1 - z_0, z_2 - z_0] (columns)               (:163-169)
  FJ     = Ehat E^{-1}, detFJ = det(FJ)                   (:206-207)
  G      = theta sqrt(det M) tr(FJ Minv FJ^T)^{dp/2}
           + (1-2 theta) d^{dp/2} sqrt(det M) (detFJ/sqrt(det M))^p
  Ih     = |det E| / 2 * G                                (:222, :274)

The gradient is the reference's hand-derived formula (:232-271), not the
autodiff gradient of the sampled energy. ``detFJ`` and the trace are
clamped to a tiny positive floor so fractional powers never see a
negative base. Small matrix products are written out as broadcast sums.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .monitor_grid import sample_frozen

P_EXP = 1.5  # AdaptationFunctional.cpp:210
THETA = 1.0 / 3.0  # :211
_DET_FLOOR = 1e-30
D_FACT = 2.0  # D! for D = 2 (:128-132)


def reference_ehat(n_elements: int) -> np.ndarray:
    """The constant reference edge matrix (:176-201), float64: a fixed
    simplex edge matrix normalized to |det| = D!, scaled by N^{-1/D}."""
    base = np.array([[1.0, 0.5], [0.0, math.sqrt(3.0) / 2.0]])
    det = abs(np.linalg.det(base))
    base = base * (D_FACT / det) ** (1.0 / 2)
    return base / float(n_elements) ** (1.0 / 2)


def _mm(A, B):
    """C[..., i, j] = sum_k A[..., i, k] B[..., k, j]."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _det(A):
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def _inv(A, det=None):
    if det is None:
        det = _det(A)
    adj = torch.stack(
        [
            torch.stack([A[..., 1, 1], -A[..., 0, 1]], -1),
            torch.stack([-A[..., 1, 0], A[..., 0, 0]], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def _common_terms(z, cells, ehat):
    """Shared between energy and gradient. ``z [NF, 3, 2]``, ``cells``
    from ``gather_cell`` over ``[NF, 3]``, ``ehat [2, 2]``."""
    d = 2.0
    m_pre = sample_frozen(cells, z)  # [NF, 3, 2, 2]
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
    G = THETA * det_m * tr_c**dp2 + (1.0 - 2.0 * THETA) * d**dp2 * det_m * (
        det_fj_c / det_m
    ) ** P_EXP  # :219-220
    abs_k = torch.abs(edet / D_FACT)  # :222
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
    """``(Ih [NF], grad [NF, 3, 2])``, the reference's analytic gradient
    (:232-282). Ih is unregularized; the gradient carries the prox term
    when ``dxpu`` is given."""
    t = _common_terms(z, cells, ehat)
    d, dp2 = t["d"], t["dp2"]
    G, det_m, tr, det_fj = t["G"], t["det_m"], t["tr"], t["det_fj"]
    minv, einv, fj, fjt, minv_jt = (
        t["minv"], t["einv"], t["fj"], t["fjt"], t["minv_jt"]
    )
    m_pre = t["m_pre"]

    def s(a):  # per-element scalar -> broadcast over [2, 2]
        return a[..., None, None]

    dGdJ = s(d * P_EXP * THETA * det_m * tr ** (dp2 - 1.0)) * minv_jt  # :232
    dGddet = (
        P_EXP * (1.0 - 2.0 * THETA) * d**dp2 * det_m ** (1.0 - P_EXP)
        * det_fj ** (P_EXP - 1.0)
    )  # :233
    dGdM = s(
        -0.5 * THETA * d * P_EXP * det_m * tr ** (dp2 - 1.0)
    ) * _mm(_mm(minv.transpose(-1, -2), fjt), _mm(fj, minv)) + s(
        0.5 * THETA * det_m * tr**dp2
        + (0.5 - THETA) * (1.0 - P_EXP) * d**dp2
        * det_m ** (1.0 - P_EXP) * det_fj**P_EXP
    ) * minv  # :234-236

    # basisComb = sum_j einv.row(j) * tr(dGdM (mPre_{j+1} - mPre_0)) (:239-244)
    dm = m_pre[:, 1:] - m_pre[:, :1]  # [NF, 2, 2, 2]
    traces = (dm * dGdM.transpose(-1, -2)[:, None]).sum((-2, -1))  # [NF, 2]
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
