// The 3D Huang functional on one tetrahedron, for kernels K4, K4' and K4''
// (prox3d.cu), on values or dual numbers (dual.cuh): the trilinear monitor
// sample from a vertex's 54 cell channels, the terms shared by energy and
// gradient, the energy and the analytic gradient. Ehat (row-major 3x3) is an
// argument: K4 passes the constant reference one, K4' each element's own.
// The cell channels come through an accessor, `cells(c)`: `SharedCells` reads
// them from a block's staged copy.
//
// Templated on the real type R (float or double; the Ehat, the constants
// and the staged inputs are in R) and on T, R or Dual<R>.
//
// Port of the component math of mmadmm_tpu/ops/prox_pallas3d.py
// (_sample_m3, _common_c3, energy_c3, grad_c3). ops/prox3d.py repeats these
// operations in the same order, so with --fmad=false a kernel built on them
// agrees with its plain PyTorch version bit for bit.

#pragma once

#include "dual.cuh"

namespace {

// K4's constant Ehat, row-major
template <typename R>
struct Ehat3 {
  R h[9];
};

// The constants in R, rounded on the host exactly as ops/prox3d.py rounds
// them in that dtype (ops/prox3d.py::_consts3, in this order)
template <typename R>
struct Consts3 {
  R w2, half_w2, inv_w2, tol;
  R k_third, k_g2, k_dgddet, k_sm2a, k_sm2b;
};

// One element's 216 cell channels in shared memory, [channel][kE] for the kE
// elements of a block: 32-bit offsets, and the elements of a warp on
// consecutive words.
template <typename R, int kE>
struct SharedCells {
  const R* p;  // the block's staged cells + the element's index in the block
  __device__ __forceinline__ R operator()(int c) const { return p[c * kE]; }
};

template <typename T>
__device__ __forceinline__ T dot3(T a0, T a1, T a2, T b0, T b1, T b2) {
  return a0 * b0 + a1 * b1 + a2 * b2;
}

// row-major 3x3 product C = A B
template <typename A, typename B, typename T>
__device__ __forceinline__ void mm33(const A* a, const B* b, T* c) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[i * 3 + j] = a[i * 3] * b[j] + a[i * 3 + 1] * b[3 + j] + a[i * 3 + 2] * b[6 + j];
}

template <typename T>
__device__ __forceinline__ T det33(const T* a) {
  return a[0] * (a[4] * a[8] - a[5] * a[7]) - a[1] * (a[3] * a[8] - a[5] * a[6]) +
         a[2] * (a[3] * a[7] - a[4] * a[6]);
}

// adjugate over det, the cofactor layout of the JAX package's huang._inv
template <typename T>
__device__ __forceinline__ void inv33(const T* a, T det, T* o) {
  using R = real_t<T>;
  T r = R(1) / det;
  o[0] = (a[4] * a[8] - a[5] * a[7]) * r;
  o[1] = (a[2] * a[7] - a[1] * a[8]) * r;
  o[2] = (a[1] * a[5] - a[2] * a[4]) * r;
  o[3] = (a[5] * a[6] - a[3] * a[8]) * r;
  o[4] = (a[0] * a[8] - a[2] * a[6]) * r;
  o[5] = (a[2] * a[3] - a[0] * a[5]) * r;
  o[6] = (a[3] * a[7] - a[4] * a[6]) * r;
  o[7] = (a[1] * a[6] - a[0] * a[7]) * r;
  o[8] = (a[0] * a[4] - a[1] * a[3]) * r;
}

// trilinear sample (m00, m01, m02, m11, m12, m22) of vertex v's cell
template <typename T, typename C>
__device__ __forceinline__ void sample_m3(const C& c, int v, T x, T y, T z, T* m) {
  using R = real_t<T>;
  const int b = v * 54;
  T xd = (x - c(b + 48)) / (c(b + 49) - c(b + 48));
  T yd = (y - c(b + 50)) / (c(b + 51) - c(b + 50));
  T zd = (z - c(b + 52)) / (c(b + 53) - c(b + 52));
  T wts[8] = {
      (R(1) - xd) * (R(1) - yd) * (R(1) - zd), xd * (R(1) - yd) * (R(1) - zd),
      (R(1) - xd) * yd * (R(1) - zd),          xd * yd * (R(1) - zd),
      (R(1) - xd) * (R(1) - yd) * zd,          xd * (R(1) - yd) * zd,
      (R(1) - xd) * yd * zd,                   xd * yd * zd,
  };
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    T s = wts[0] * c(b + e);
#pragma unroll
    for (int k = 1; k < 8; ++k) s = s + wts[k] * c(b + k * 6 + e);
    m[e] = s;
  }
}

template <typename T>
__device__ __forceinline__ T q225(T t) { return t * t * sqrt_(sqrt_(t)); }
template <typename T>
__device__ __forceinline__ T q125(T t) { return t * sqrt_(sqrt_(t)); }

template <typename T>
struct Common3 {
  T m[4][6];
  T mi[9], ei[9], fj[9], mj[9];
  T tr, det_m, det_fj, G, abs_k, inv_sqrt_dm, sqrt_dfj, dfj32;
};

// the four vertices' samples at z into m, each vertex's cell by sample_m3;
// a cells accessor may bring an overload of its own (found by its type)
template <typename T, typename C>
__device__ __forceinline__ void sample4(const C& cells, const T* z, T (*m)[6]) {
#pragma unroll
  for (int v = 0; v < 4; ++v) sample_m3(cells, v, z[3 * v], z[3 * v + 1], z[3 * v + 2], m[v]);
}

template <typename T, typename C, typename R>
__device__ __forceinline__ void common3(const T* z, const C& cells, const R* h,
                                        const Consts3<R>& k, Common3<T>& t) {
  sample4(cells, z, t.m);
  T ms[6];
#pragma unroll
  for (int e = 0; e < 6; ++e) ms[e] = t.m[0][e] + t.m[1][e] + t.m[2][e] + t.m[3][e];
  T ms_full[9] = {ms[0], ms[1], ms[2], ms[1], ms[3], ms[4], ms[2], ms[4], ms[5]};
  inv33(ms_full, det33(ms_full), t.mi);
#pragma unroll
  for (int i = 0; i < 9; ++i) t.mi[i] = t.mi[i] * R(0.25);

  T E[9];  // E[d][j] = z_{j+1, d} - z_{0, d}
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int j = 0; j < 3; ++j) E[d * 3 + j] = z[3 * (j + 1) + d] - z[d];
  T edet = det33(E);
  inv33(E, edet, t.ei);
  mm33(h, t.ei, t.fj);
  T det_fj = det33(t.fj);

#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      t.mj[a * 3 + b] = dot3(t.mi[a * 3], t.mi[a * 3 + 1], t.mi[a * 3 + 2], t.fj[b * 3],
                             t.fj[b * 3 + 1], t.fj[b * 3 + 2]);
  T tr = t.fj[0] * t.mj[0];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (i || j) tr = tr + t.fj[i * 3 + j] * t.mj[j * 3 + i];

  t.det_m = sqrt_(R(1) / max_floor(det33(t.mi), Num<R>::kDetFloor));
  t.tr = max_floor(tr, Num<R>::kDetFloor);
  t.det_fj = max_floor(det_fj, Num<R>::kDetFloor);
  t.inv_sqrt_dm = R(1) / sqrt_(t.det_m);
  t.sqrt_dfj = sqrt_(t.det_fj);
  t.dfj32 = t.det_fj * t.sqrt_dfj;
  t.G = k.k_third * t.det_m * q225(t.tr) + k.k_g2 * t.dfj32 * t.inv_sqrt_dm;
  t.abs_k = abs_(edet / R(6));
}

template <typename T, typename R>
__device__ __forceinline__ T reg3(const T* z, const R* dxpu) {
  T d = dxpu[0] - z[0];
  T s = d * d;
#pragma unroll
  for (int i = 1; i < 12; ++i) {
    d = dxpu[i] - z[i];
    s = s + d * d;
  }
  return s;
}

template <typename C, typename R>
__device__ __forceinline__ R energy3_unreg(const R* z, const C& cells, const R* h,
                                           const Consts3<R>& k) {
  Common3<R> t;
  common3(z, cells, h, k, t);
  return t.abs_k * t.G;
}

// the regularized energy at z
template <typename C, typename R>
__device__ __forceinline__ R energy3(const R* z, const C& cells, const R* h, const R* dxpu,
                                     const Consts3<R>& k) {
  return energy3_unreg(z, cells, h, k) + k.half_w2 * reg3(z, dxpu);
}

// masked regularized gradient into g, the unregularized energy into ih;
// returns the regularized energy
template <typename T, typename C, typename R>
__device__ __forceinline__ T grad3(const T* z, const C& cells, const R* h, const R* dxpu,
                                   const R* fr, const Consts3<R>& k, T* g, T& ih) {
  Common3<T> t;
  common3(z, cells, h, k, t);
  T s_j = R(1.5) * t.det_m * q125(t.tr);
  T dj[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) dj[i] = s_j * t.mj[i];
  T dgddet = k.k_dgddet * t.inv_sqrt_dm * t.sqrt_dfj;

  T A[9], B[9];
  mm33(t.fj, t.mi, A);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      B[i * 3 + j] = dot3(A[i], A[3 + i], A[6 + i], A[j], A[3 + j], A[6 + j]);
  T s_m1 = R(-0.5) * s_j;
  T s_m2 = k.k_sm2a * t.det_m * q225(t.tr) + (k.k_sm2b * t.inv_sqrt_dm * t.dfj32);
  T dgs[6];  // dGdM's symmetric entries (00, 01, 02, 11, 12, 22)
  const int sym[6] = {0, 1, 2, 4, 5, 8};
#pragma unroll
  for (int e = 0; e < 6; ++e) dgs[e] = s_m1 * B[sym[e]] + s_m2 * t.mi[sym[e]];
  const R sym_w[6] = {R(1), R(2), R(2), R(1), R(2), R(1)};

  T tc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    T s = sym_w[0] * (t.m[j + 1][0] - t.m[0][0]) * dgs[0];
#pragma unroll
    for (int e = 1; e < 6; ++e) s = s + sym_w[e] * (t.m[j + 1][e] - t.m[0][e]) * dgs[e];
    tc[j] = s;
  }
  T bc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) bc[c] = dot3(tc[0], tc[1], tc[2], t.ei[c], t.ei[3 + c], t.ei[6 + c]);

  T c1 = -t.G + dgddet * t.det_fj;
  T Q[9], qf[9];
  mm33(t.ei, dj, Q);
  mm33(Q, t.fj, qf);
  T v_loc[9];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v_loc[j * 3 + c] = c1 * t.ei[j * 3 + c] + qf[j * 3 + c] - bc[c] * R(0.25);

  T abs_k = t.abs_k;
  T raw[12];
#pragma unroll
  for (int c = 0; c < 3; ++c) raw[c] = (v_loc[c] + v_loc[3 + c] + v_loc[6 + c] + bc[c]) * abs_k;
#pragma unroll
  for (int i = 0; i < 9; ++i) raw[3 + i] = -v_loc[i] * abs_k;
  ih = abs_k * t.G;
  T e_reg = ih + k.half_w2 * reg3(z, dxpu);
#pragma unroll
  for (int i = 0; i < 12; ++i) g[i] = (raw[i] + k.w2 * (z[i] - dxpu[i])) * fr[i];
  return e_reg;
}

}  // namespace
