// K4, K4' and K4'': the 3D ADMM prox z-update, one thread per tetrahedron.
//
// K4 replaces mmadmm_tpu/ops/prox_pallas3d.py::make_prox_pallas3d (:263, its
// pl.pallas_call at :418) with chord=False, comp_mesh=False. For each
// element it runs up to max_iters damped-Newton sweeps on
//     I_h(z) + 0.5 w^2 |dxpu - z|^2
// with the analytic Huang gradient, the 12x12 Hessian as the forward
// derivative of that gradient (dual numbers, one pass per column), an
// unrolled LDL^T solve with the -g/w^2 fallback, and 5 backtracking trials.
//
// K4' replaces the same call site with chord=True, comp_mesh=True (the
// sweep of mmadmm_tpu/ops/prox_pallas2d.py::make_chord_sweeps, :362-448),
// the prox of every 3D computational-mesh run. Each element brings its own
// Ehat, the edge matrix of its computational (xi-mesh) vertices, as 9 more
// channels. Its Hessian is built once at entry and cached; each sweep solves
// with the cached Hessian and tries that step once, at alpha 1, and only an
// element that rejects it rebuilds the Hessian at its current z, re-solves
// and backtracks as K4 does (a refresh).
//
// K4'' is the same call site with the other two flag combinations, which
// the JAX package reaches through its MMADMM_PROX_CHORD switch (mesh.py:
// 183-187) and the port through MovingMesh's prox_chord: K4''a, chord=True,
// comp_mesh=False (chord sweeps with the constant Ehat), and K4''b,
// chord=False, comp_mesh=True (Newton sweeps with each element's Ehat).
//
// The plain PyTorch versions in ops/prox3d.py (prox3d_plain,
// prox3d_chord_comp_plain, prox3d_chord_plain, prox3d_comp_plain) perform
// the same operations in the same order; built with --fmad=false each
// kernel agrees with its plain version bit for bit.
//
// Layout: channel-major [C, n] float32, channel stride n. z, dxpu, free are
// [12, n] (channel v*3 + d); cells is [216, n]: per vertex, its cell's 8
// corners as (m00, m01, m02, m11, m12, m22), then x0, x1, y0, y1, z0, z1;
// K4' and K4''b also read ehat [9, n], row-major [d][j] = xi_{j+1, d} -
// xi_{0, d}.
// Outputs: zout [12, n] and ih0 [n], the unregularized energy at the input.
//
// What bounds them on the H100: arithmetic. A K4 element reads 252 floats
// and writes 13, (3*12 + 216 + 12 + 1) * 4 = 1,060 bytes: 814 MB, 0.243 ms
// at 3.35 TB/s for the 768,000 slots of a 40^3 box mesh; a K4' or K4''b
// element reads 9 more, 1,096 bytes. Each Newton sweep does tens of
// thousands of float operations (the twelve dual passes of the Hessian take most of
// them; the op counter of chip_smoke.py on the plain versions gives the
// count for the inputs at hand), and elements take 1 to max_iters sweeps. A
// chord sweep that keeps its cached step costs one gradient, one solve and
// one trial energy, a few thousand operations; that is what chord sweeps
// save on weakly regularized runs (rho = 10 in the 3DMonitor3 family), whose
// elements stay active for many sweeps.
//
// The design is K1's, simple and right first: one thread per element with
// its own sweep loop, retiring on its own, so no result depends on a
// neighbour. Registers cannot hold a 12x12 system beside the dual gradient,
// so each dual pass writes its Hessian column, the 78-entry lower triangle,
// to shared memory laid out [78][blockDim] (thread index fastest: no bank
// conflicts, 39 KB at 128 threads), where it is factored in place. The
// chord sweeps keep that factored triangle (L and D) across sweeps as its cache: the
// JAX kernel caches H and factors it again every sweep, and factoring the
// same H gives the same L and D, so solving with the cached factors gives
// the same bits. A second 78-entry buffer for H itself would cost another
// 39,936 bytes of shared memory per block and halve the blocks per SM, for
// nothing. The 216 cell channels are read from device memory (__ldg,
// adjacent threads on adjacent addresses) where they are used, not held in
// registers; they are re-read from the caches by every gradient and energy.

#include <cstring>

#include "huang3d.cuh"

namespace {

static_assert(sizeof(Consts3) == 9 * sizeof(float), "Consts3 is 9 packed floats");

constexpr int kThreads = 128;
constexpr int kTri = 78;  // entries of the lower triangle of a 12x12 matrix
constexpr float kDiagFloor = 1e-12f;
constexpr float kEpsStall = 10.0f * 1.1920928955078125e-07f;

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// NaN-propagating max (torch.maximum)
__device__ __forceinline__ float maxnan(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float edet3(const float* z) {
  float E[9];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int j = 0; j < 3; ++j) E[d * 3 + j] = z[3 * (j + 1) + d] - z[d];
  return det33(E);
}

#define HS(i, j) H[tri(i, j) * kThreads]

// the lower triangle of the Hessian at z into H (this thread's column of
// the shared array, H[tri(i, j) * kThreads]), one dual pass per column
__device__ __forceinline__ void hess12(const float* z, const Cells& cells, const float* h,
                                       const float* dxpu, const float* fr, const Consts3& k,
                                       const float* free_col, long long n, float* H) {
#pragma unroll 1
  for (int j = 0; j < 12; ++j) {
    Dual zd[12], gd[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) zd[i] = {z[i], i == j ? 1.0f : 0.0f};
    Dual ihd;
    grad3<Dual>(zd, cells, h, dxpu, fr, k, gd, ihd);
    const float frj = __ldg(free_col + j * n);
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      if (i < j) continue;
      float hv = gd[i].d * fr[i] * frj;
      if (i == j) hv = hv + (1.0f - fr[i]) + kLevenberg;
      HS(i, j) = hv;
    }
  }
}

// H = L D L^T in place: D on the diagonal, L below it (ops/newton.py::ldlt_c)
__device__ __forceinline__ void factor12(float* H) {
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    float d = HS(j, j);
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - HS(j, k) * HS(j, k) * HS(k, k);
    d = fabsf(d) < kDiagFloor ? kDiagFloor : d;
    HS(j, j) = d;
#pragma unroll
    for (int i = j + 1; i < 12; ++i) {
      float s = HS(i, j);
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - HS(i, k) * HS(j, k) * HS(k, k);
      HS(i, j) = s / d;
    }
  }
}

// the step p = -H^{-1} g from the factored H, or -g/w^2 where it is not finite
__device__ __forceinline__ void direction(const float* H, const float* g, float inv_w2,
                                          float* p) {
  float zv[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    float s = -g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - HS(i, k) * zv[k];
    zv[i] = s;
  }
#pragma unroll
  for (int i = 11; i >= 0; --i) {
    float s = zv[i] / HS(i, i);
#pragma unroll
    for (int k = i + 1; k < 12; ++k) s = s - HS(k, i) * p[k];
    p[i] = s;
  }
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 12; ++i) finite = finite && isfinite(p[i]);
  if (!finite) {
#pragma unroll
    for (int i = 0; i < 12; ++i) p[i] = -g[i] * inv_w2;
  }
}

#undef HS

// a trial point is accepted at a finite energy not above e0 whose
// orientation determinant stays above det_floor
__device__ __forceinline__ bool trial_ok(const float* zt, const Cells& cells, const float* h,
                                         const float* dxpu, const Consts3& k, float e0,
                                         float det_floor) {
  float e_t = energy3(zt, cells, h, dxpu, k);
  return isfinite(e_t) && e_t <= e0 && edet3(zt) > det_floor;
}

// backtracking: the largest accepted alpha, 0 if none
__device__ __forceinline__ float backtrack(const float* z, const float* p, const Cells& cells,
                                           const float* h, const float* dxpu, const Consts3& k,
                                           float e0, float det_floor) {
  const float alphas[5] = {0.0625f, 0.125f, 0.25f, 0.5f, 1.0f};
  float alpha = 0.0f;
#pragma unroll 1
  for (int a = 0; a < 5; ++a) {
    float zt[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) zt[i] = z[i] + alphas[a] * p[i];
    if (trial_ok(zt, cells, h, dxpu, k, e0, det_floor)) alpha = alphas[a];
  }
  return alpha;
}

// min(det0, 0), NaN kept (torch.clamp_max)
__device__ __forceinline__ float floor_of(float det0) {
  return det0 < 0.0f ? det0 : (det0 != det0 ? det0 : 0.0f);
}

// the gradient's 1-norm, in channel order
__device__ __forceinline__ float norm1(const float* g) {
  float s = fabsf(g[0]);
#pragma unroll
  for (int i = 1; i < 12; ++i) s = s + fabsf(g[i]);
  return s;
}

// max |v_i|, NaN kept, in channel order
__device__ __forceinline__ float absmax(const float* v) {
  float m = fabsf(v[0]);
#pragma unroll
  for (int i = 1; i < 12; ++i) m = maxnan(m, fabsf(v[i]));
  return m;
}

// K4, K4' and K4'' are one kernel: kChord selects chord sweeps (K4', K4''a)
// over Newton sweeps (K4, K4''b), kComp a per-element Ehat read from
// ehat_in (K4', K4''b) over the constant eh (K4, K4''a). Each sweep keeps
// its JAX counterpart's order: a Newton sweep (make_newton_sweeps) finds its
// step and then retires on a small gradient; a chord sweep
// (make_chord_sweeps) retires before it solves.
//
// The chord sweep's refresh: the JAX kernel guards it per tile (pl.when over
// the tile's max of active & ~ok1) and writes the new Hessian and step only
// where the cached step was rejected (h_write(H2, keep=ok1), where(ok1, p,
// alpha p2)). Here the guard is per element, and gives the same results: an
// element that accepts the cached step keeps its cached Hessian and that
// step whether or not a neighbour refreshes, and an element the JAX kernel
// refreshes without needing it is one that is no longer active, which never
// moves again. An element that retires on its gradient norm does not move
// either, so it leaves before the solve.
template <bool kChord, bool kComp>
__global__ void __launch_bounds__(kThreads) prox3d_kernel(
    const float* __restrict__ z_in, const float* __restrict__ dxpu_in,
    const float* __restrict__ free_in, const float* __restrict__ cells_in,
    const float* __restrict__ ehat_in, float* __restrict__ zout, float* __restrict__ ih0_out,
    long long n, Ehat3 eh, Consts3 k, int max_iters) {
  __shared__ float hess[kTri * kThreads];
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float* H = hess + threadIdx.x;  // chord sweeps: the cached Hessian, factored
  const Cells cells{cells_in + e, n};
  float z[12], dxpu[12], fr[12], h_e[9];
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    z[c] = z_in[c * n + e];
    dxpu[c] = dxpu_in[c * n + e];
    fr[c] = free_in[c * n + e];
  }
  const float* h = eh.h;
  if constexpr (kComp) {
#pragma unroll
    for (int c = 0; c < 9; ++c) h_e[c] = ehat_in[c * n + e];
    h = h_e;
  }

  ih0_out[e] = energy3_unreg(z, cells, h, k);
  if constexpr (kChord) {
    hess12(z, cells, h, dxpu, fr, k, free_in + e, n, H);
    factor12(H);
  }

  for (int it = 0; it < max_iters; ++it) {
    // gradient, its norm and the regularized energy at the start
    float g[12];
    float ih;
    float e0 = grad3<float>(z, cells, h, dxpu, fr, k, g, ih);
    if constexpr (kChord) {
      // retire on a small gradient from the second sweep on, before moving
      if (it > 0 && norm1(g) < k.tol) break;
      float det_floor = floor_of(edet3(z));

      // the cached Hessian's step, tried once at alpha 1
      float p[12], zt[12];
      direction(H, g, k.inv_w2, p);
#pragma unroll
      for (int i = 0; i < 12; ++i) zt[i] = z[i] + p[i];
      if (!trial_ok(zt, cells, h, dxpu, k, e0, det_floor)) {
        // refresh: the Hessian at z replaces the cache, then backtracking
        hess12(z, cells, h, dxpu, fr, k, free_in + e, n, H);
        factor12(H);
        direction(H, g, k.inv_w2, p);
        float alpha = backtrack(z, p, cells, h, dxpu, k, e0, det_floor);
#pragma unroll
        for (int i = 0; i < 12; ++i) p[i] = alpha * p[i];
      }
      bool stalled = absmax(p) <= kEpsStall * (1.0f + absmax(z));
#pragma unroll
      for (int i = 0; i < 12; ++i) z[i] = z[i] + p[i];
      if (stalled) break;
    } else {
      float gnorm = norm1(g);

      float p[12];
      hess12(z, cells, h, dxpu, fr, k, free_in + e, n, H);
      factor12(H);
      direction(H, g, k.inv_w2, p);

      float det_floor = floor_of(edet3(z));
      float alpha = backtrack(z, p, cells, h, dxpu, k, e0, det_floor);
      float step_inf = alpha * absmax(p);
      bool stalled = step_inf <= kEpsStall * (1.0f + absmax(z));
      // retire on a small gradient from the second sweep on, before moving
      if (it > 0 && gnorm < k.tol) break;
#pragma unroll
      for (int i = 0; i < 12; ++i) z[i] = z[i] + alpha * p[i];
      if (stalled) break;
    }
  }
#pragma unroll
  for (int c = 0; c < 12; ++c) zout[c * n + e] = z[c];
}

template <bool kChord, bool kComp>
int launch(const float* z, const float* dxpu, const float* free_, const float* cells,
           const float* ehat, float* zout, float* ih0, long long n, const float* consts,
           int max_iters, void* stream) {
  if (n <= 0) return 0;
  Ehat3 eh{};
  Consts3 k;
  if constexpr (!kComp) std::memcpy(&eh, consts, sizeof(eh));
  std::memcpy(&k, consts + (kComp ? 0 : 9), sizeof(k));
  const long long blocks = (n + kThreads - 1) / kThreads;
  prox3d_kernel<kChord, kComp><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      z, dxpu, free_, cells, ehat, zout, ih0, n, eh, k, max_iters);
  return (int)cudaGetLastError();
}

}  // namespace

// consts: K4 and K4''a take 18 floats, Ehat row-major, then the 9 of
// Consts3 (w^2, w^2/2, 1/w^2, tol, then the five f32 constants of
// ops/prox3d.py); K4' and K4''b take the 9 of Consts3 and ehat [9, n], each
// element's own Ehat.
extern "C" int mm_prox3d(const float* z, const float* dxpu, const float* free_,
                         const float* cells, float* zout, float* ih0, long long n,
                         const float* consts, int max_iters, void* stream) {
  return launch<false, false>(z, dxpu, free_, cells, nullptr, zout, ih0, n, consts, max_iters,
                              stream);
}

extern "C" int mm_prox3d_chord_comp(const float* z, const float* dxpu, const float* free_,
                                    const float* cells, const float* ehat, float* zout,
                                    float* ih0, long long n, const float* consts, int max_iters,
                                    void* stream) {
  return launch<true, true>(z, dxpu, free_, cells, ehat, zout, ih0, n, consts, max_iters,
                            stream);
}

extern "C" int mm_prox3d_chord(const float* z, const float* dxpu, const float* free_,
                               const float* cells, float* zout, float* ih0, long long n,
                               const float* consts, int max_iters, void* stream) {
  return launch<true, false>(z, dxpu, free_, cells, nullptr, zout, ih0, n, consts, max_iters,
                             stream);
}

extern "C" int mm_prox3d_comp(const float* z, const float* dxpu, const float* free_,
                              const float* cells, const float* ehat, float* zout, float* ih0,
                              long long n, const float* consts, int max_iters, void* stream) {
  return launch<false, true>(z, dxpu, free_, cells, ehat, zout, ih0, n, consts, max_iters,
                             stream);
}
