// The 2D Huang functional on one triangle, for the port's kernels (K1 in
// prox2d.cu, K2 and K3 in be2d.cu), on values or dual numbers
// (dual.cuh): the bilinear monitor sample from a vertex's 16-wide cell
// row, the terms shared by energy and gradient, the energy and the
// analytic gradient. Templated on the real type R (float or double), on
// T, R or Dual<R>, and on C, how the 48 cell channels are read: a pointer
// to them in registers or memory (K2, K3), or `SharedRows`, one element's
// column of a block's staged [48][kE] copy (K1).
//
// Port of the component math of mmadmm_tpu/ops/prox_pallas2d.py
// (_sample_m_c, _common_c, energy_c, grad_c). ops/prox2d.py repeats these
// operations in the same order, so with --fmad=false a kernel built on
// them agrees with its plain PyTorch version bit for bit.

#pragma once

#include "dual.cuh"

namespace {

template <typename R>
struct Consts {
  R h00, h01, h10, h11;  // Ehat, row-major
  R w2, half_w2, inv_w2, tol;
};

// The constants, rounded as the JAX kernel rounds them in its dtype (see
// ops/prox2d.py::_k2): a Python float, or a product of Python floats, is
// cast to R where it meets a tile; c_d32 is 2 sqrt(2) computed in R.
template <typename R>
__device__ __forceinline__ R third() { return R(1) / R(3); }
template <typename R>
__device__ __forceinline__ R c_d32() { return R(2) * sqrt_(R(2)); }

// One element's cell channels in a block's shared copy [channel][kE]: c[i]
// is channel i, c + i the accessor of the channels from i on (as for a
// pointer), the elements of a warp on consecutive words.
template <typename R, int kE>
struct SharedRows {
  const R* p;  // the staged cells + the element's index in the block
  __device__ __forceinline__ R operator[](int c) const { return p[c * kE]; }
  __device__ __forceinline__ SharedRows operator+(int c) const { return {p + c * kE}; }
};

template <typename T, typename C>
__device__ __forceinline__ void sample_m(C c, T x, T y, T& m0, T& m1, T& m2) {
  using R = real_t<T>;
  R x0 = c[12], x1 = c[13], y0 = c[14], y1 = c[15];
  R norm = R(1) / ((x1 - x0) * (y1 - y0));
  T c00 = norm * (x1 - x) * (y1 - y);
  T c10 = norm * (x - x0) * (y1 - y);
  T c01 = norm * (x1 - x) * (y - y0);
  T c11 = norm * (x - x0) * (y - y0);
  m0 = c00 * c[0] + c10 * c[3] + c01 * c[6] + c11 * c[9];
  m1 = c00 * c[1] + c10 * c[4] + c01 * c[7] + c11 * c[10];
  m2 = c00 * c[2] + c10 * c[5] + c01 * c[8] + c11 * c[11];
}

template <typename T>
struct Common {
  T m[3][3];
  T mi00, mi01, mi11, ei00, ei01, ei10, ei11;
  T fj00, fj01, fj10, fj11, mj00, mj01, mj10, mj11;
  T tr, det_m, det_fj, G, abs_k, sqrt_tr, sqrt_dfj, inv_sqrt_dm;
};

// the terms after the monitor samples, from the samples in t.m (see common)
template <typename T, typename R>
__device__ __forceinline__ void common_tail(const T* z, const Consts<R>& k, Common<T>& t) {
  T ms00 = t.m[0][0] + t.m[1][0] + t.m[2][0];
  T ms01 = t.m[0][1] + t.m[1][1] + t.m[2][1];
  T ms11 = t.m[0][2] + t.m[1][2] + t.m[2][2];
  T det_ms = ms00 * ms11 - ms01 * ms01;
  T q = R(1) / (R(3) * det_ms);
  t.mi00 = ms11 * q;
  t.mi01 = -ms01 * q;
  t.mi11 = ms00 * q;

  T e00 = z[2] - z[0];
  T e10 = z[3] - z[1];
  T e01 = z[4] - z[0];
  T e11 = z[5] - z[1];
  T edet = e00 * e11 - e01 * e10;
  T r = R(1) / edet;
  t.ei00 = e11 * r;
  t.ei01 = -e01 * r;
  t.ei10 = -e10 * r;
  t.ei11 = e00 * r;

  t.fj00 = k.h00 * t.ei00 + k.h01 * t.ei10;
  t.fj01 = k.h00 * t.ei01 + k.h01 * t.ei11;
  t.fj10 = k.h10 * t.ei00 + k.h11 * t.ei10;
  t.fj11 = k.h10 * t.ei01 + k.h11 * t.ei11;
  T det_fj = t.fj00 * t.fj11 - t.fj01 * t.fj10;

  t.mj00 = t.mi00 * t.fj00 + t.mi01 * t.fj01;
  t.mj01 = t.mi00 * t.fj10 + t.mi01 * t.fj11;
  t.mj10 = t.mi01 * t.fj00 + t.mi11 * t.fj01;
  t.mj11 = t.mi01 * t.fj10 + t.mi11 * t.fj11;
  T tr = t.fj00 * t.mj00 + t.fj01 * t.mj10 + t.fj10 * t.mj01 + t.fj11 * t.mj11;

  T det_minv = t.mi00 * t.mi11 - t.mi01 * t.mi01;
  t.det_m = sqrt_(R(1) / max_floor(det_minv, Num<R>::kDetFloor));
  t.tr = max_floor(tr, Num<R>::kDetFloor);
  t.det_fj = max_floor(det_fj, Num<R>::kDetFloor);
  t.sqrt_tr = sqrt_(t.tr);
  T tr32 = t.tr * t.sqrt_tr;
  t.sqrt_dfj = sqrt_(t.det_fj);
  T dfj32 = t.det_fj * t.sqrt_dfj;
  t.inv_sqrt_dm = R(1) / sqrt_(t.det_m);
  t.G = third<R>() * t.det_m * tr32 + (third<R>() * c_d32<R>()) * dfj32 * t.inv_sqrt_dm;
  t.abs_k = abs_(edet * R(0.5));
}

template <typename T, typename C, typename R>
__device__ __forceinline__ void common(const T* z, C cells, const Consts<R>& k,
                                       Common<T>& t) {
#pragma unroll
  for (int v = 0; v < 3; ++v)
    sample_m(cells + 16 * v, z[2 * v], z[2 * v + 1], t.m[v][0], t.m[v][1], t.m[v][2]);
  common_tail(z, k, t);
}

// (ih_unregularized, e_regularized) at z
template <typename C, typename R>
__device__ __forceinline__ void energy(const R* z, C cells, const R* dxpu,
                                       const Consts<R>& k, R& ih, R& e_reg) {
  Common<R> t;
  common(z, cells, k, t);
  ih = t.abs_k * t.G;
  R reg = (dxpu[0] - z[0]) * (dxpu[0] - z[0]);
  for (int i = 1; i < 6; ++i) reg = reg + (dxpu[i] - z[i]) * (dxpu[i] - z[i]);
  e_reg = ih + k.half_w2 * reg;
}

template <typename C, typename R>
__device__ __forceinline__ R energy_unreg(const R* z, C cells, const Consts<R>& k) {
  Common<R> t;
  common(z, cells, k, t);
  return t.abs_k * t.G;
}

// the unregularized, unmasked gradient at the point of t into raw
template <typename T, typename R = real_t<T>>
__device__ __forceinline__ void raw_grad(const Common<T>& t, T* raw) {
  T s_j = t.det_m * t.sqrt_tr;
  T dj00 = s_j * t.mj00;
  T dj01 = s_j * t.mj01;
  T dj10 = s_j * t.mj10;
  T dj11 = s_j * t.mj11;
  T dgddet = ((R)(1.5 * (1.0 / 3.0)) * c_d32<R>()) * t.inv_sqrt_dm * t.sqrt_dfj;

  T a00 = t.fj00 * t.mi00 + t.fj01 * t.mi01;
  T a01 = t.fj00 * t.mi01 + t.fj01 * t.mi11;
  T a10 = t.fj10 * t.mi00 + t.fj11 * t.mi01;
  T a11 = t.fj10 * t.mi01 + t.fj11 * t.mi11;
  T b00 = a00 * a00 + a10 * a10;
  T b01 = a00 * a01 + a10 * a11;
  T b11 = a01 * a01 + a11 * a11;
  T s_m1 = R(-0.5) * s_j;
  T tr32 = t.tr * t.sqrt_tr;
  T dfj32 = t.det_fj * t.sqrt_dfj;
  // Python doubles rounded to R where they meet a tile, as in JAX
  const R k_sm2a = (R)(0.5 * (1.0 / 3.0));
  const R k_sm2b = (R)((0.5 - 1.0 / 3.0) * (1.0 - 1.5)) * c_d32<R>();
  T s_m2 = k_sm2a * t.det_m * tr32 + (k_sm2b * t.inv_sqrt_dm * dfj32);
  T dm00 = s_m1 * b00 + s_m2 * t.mi00;
  T dm01 = s_m1 * b01 + s_m2 * t.mi01;
  T dm11 = s_m1 * b11 + s_m2 * t.mi11;

  T d10 = t.m[1][0] - t.m[0][0], d11 = t.m[1][1] - t.m[0][1], d12 = t.m[1][2] - t.m[0][2];
  T d20 = t.m[2][0] - t.m[0][0], d21 = t.m[2][1] - t.m[0][1], d22 = t.m[2][2] - t.m[0][2];
  T tr1 = d10 * dm00 + R(2) * d11 * dm01 + d12 * dm11;
  T tr2 = d20 * dm00 + R(2) * d21 * dm01 + d22 * dm11;
  T bc0 = tr1 * t.ei00 + tr2 * t.ei10;
  T bc1 = tr1 * t.ei01 + tr2 * t.ei11;

  T c1 = -t.G + dgddet * t.det_fj;
  T q00 = t.ei00 * dj00 + t.ei01 * dj10;
  T q01 = t.ei00 * dj01 + t.ei01 * dj11;
  T q10 = t.ei10 * dj00 + t.ei11 * dj10;
  T q11 = t.ei10 * dj01 + t.ei11 * dj11;
  T v00 = c1 * t.ei00 + q00 * t.fj00 + q01 * t.fj10 - bc0 * third<R>();
  T v01 = c1 * t.ei01 + q00 * t.fj01 + q01 * t.fj11 - bc1 * third<R>();
  T v10 = c1 * t.ei10 + q10 * t.fj00 + q11 * t.fj10 - bc0 * third<R>();
  T v11 = c1 * t.ei11 + q10 * t.fj01 + q11 * t.fj11 - bc1 * third<R>();

  T g0x = v00 + v10 + bc0;
  T g0y = v01 + v11 + bc1;
  T abs_k = t.abs_k;
  raw[0] = g0x * abs_k;
  raw[1] = g0y * abs_k;
  raw[2] = -v00 * abs_k;
  raw[3] = -v01 * abs_k;
  raw[4] = -v10 * abs_k;
  raw[5] = -v11 * abs_k;
}

// masked regularized gradient into g, the unregularized energy into ih;
// returns e_reg
template <typename T, typename C, typename R>
__device__ __forceinline__ T grad(const T* z, C cells, const R* dxpu, const R* fr,
                                  const Consts<R>& k, T* g, T& ih) {
  Common<T> t;
  common(z, cells, k, t);
  T raw[6];
  raw_grad(t, raw);
  ih = t.abs_k * t.G;
  T reg = (dxpu[0] - z[0]) * (dxpu[0] - z[0]);
  for (int i = 1; i < 6; ++i) reg = reg + (dxpu[i] - z[i]) * (dxpu[i] - z[i]);
  T e_reg = ih + k.half_w2 * reg;
  for (int i = 0; i < 6; ++i) g[i] = (raw[i] + k.w2 * (z[i] - dxpu[i])) * fr[i];
  return e_reg;
}

}  // namespace
