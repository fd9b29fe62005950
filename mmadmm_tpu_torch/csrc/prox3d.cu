// K4: the 3D ADMM prox z-update, one thread per tetrahedron.
//
// Replaces mmadmm_tpu/ops/prox_pallas3d.py::make_prox_pallas3d (:263, its
// pl.pallas_call at :418) with chord=False, comp_mesh=False. For each
// element it runs up to max_iters damped-Newton sweeps on
//     I_h(z) + 0.5 w^2 |dxpu - z|^2
// with the analytic Huang gradient, the 12x12 Hessian as the forward
// derivative of that gradient (dual numbers, one pass per column), an
// unrolled LDL^T solve with the -g/w^2 fallback, and 5 backtracking trials.
// The plain PyTorch version in ops/prox3d.py performs the same operations
// in the same order; built with --fmad=false the two agree bit for bit.
//
// Layout: channel-major [C, n] float32, channel stride n. z, dxpu, free are
// [12, n] (channel v*3 + d); cells is [216, n]: per vertex, its cell's 8
// corners as (m00, m01, m02, m11, m12, m22), then x0, x1, y0, y1, z0, z1.
// Outputs: zout [12, n] and ih0 [n], the unregularized energy at the input.
//
// What bounds it on the H100: arithmetic. An element reads 252 floats and
// writes 13, (3*12 + 216 + 12 + 1) * 4 = 1,060 bytes: 814 MB, 0.243 ms at
// 3.35 TB/s for the 768,000 slots of a 40^3 box mesh. Each sweep does tens
// of thousands of float operations (the twelve dual passes of the gradient
// take most of them; the op counter of chip_smoke.py on the plain version
// gives the count for the inputs at hand), and elements take 1 to max_iters
// sweeps. The design is K1's, simple and right first: one thread per
// element with its own sweep loop, retiring on its own, so no result
// depends on a neighbour. Registers cannot hold a 12x12 system beside the
// dual gradient, so each dual pass writes its Hessian column, the 78-entry
// lower triangle, to shared memory laid out [78][blockDim] (thread index
// fastest: no bank conflicts, 39 KB at 128 threads), where it is factored in
// place. The 216 cell channels are read from device memory (__ldg, adjacent
// threads on adjacent addresses) where they are used, not held in
// registers; they are re-read from the caches by every gradient and energy.

#include <cstring>

#include "huang3d.cuh"

namespace {

static_assert(sizeof(Consts3) == 18 * sizeof(float), "Consts3 is 18 packed floats");

constexpr int kThreads = 128;
constexpr int kTri = 78;  // entries of the lower triangle of a 12x12 matrix
constexpr float kDiagFloor = 1e-12f;

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

// H x = b, H's lower triangle at H[tri(i, j) * kThreads] (this thread's
// column of the shared array), factored in place into L and D
__device__ __forceinline__ void ldlt12(float* H, const float* b, float* x) {
#define HS(i, j) H[tri(i, j) * kThreads]
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
  float zv[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - HS(i, k) * zv[k];
    zv[i] = s;
  }
#pragma unroll
  for (int i = 11; i >= 0; --i) {
    float s = zv[i] / HS(i, i);
#pragma unroll
    for (int k = i + 1; k < 12; ++k) s = s - HS(k, i) * x[k];
    x[i] = s;
  }
#undef HS
}

__global__ void __launch_bounds__(kThreads) prox3d_kernel(
    const float* __restrict__ z_in, const float* __restrict__ dxpu_in,
    const float* __restrict__ free_in, const float* __restrict__ cells_in,
    float* __restrict__ zout, float* __restrict__ ih0_out, long long n, Consts3 k,
    int max_iters) {
  __shared__ float hess[kTri * kThreads];
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float* H = hess + threadIdx.x;
  const Cells cells{cells_in + e, n};
  float z[12], dxpu[12], fr[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    z[c] = z_in[c * n + e];
    dxpu[c] = dxpu_in[c * n + e];
    fr[c] = free_in[c * n + e];
  }

  ih0_out[e] = energy3_unreg(z, cells, k);
  const float alphas[5] = {0.0625f, 0.125f, 0.25f, 0.5f, 1.0f};
  const float eps_stall = 10.0f * 1.1920928955078125e-07f;

  for (int it = 0; it < max_iters; ++it) {
    // gradient, its norm and the regularized energy at the start
    float g[12];
    float ih;
    float e0 = grad3<float>(z, cells, dxpu, fr, k, g, ih);
    float gnorm = fabsf(g[0]);
#pragma unroll
    for (int i = 1; i < 12; ++i) gnorm = gnorm + fabsf(g[i]);

    // Hessian, lower triangle, one dual pass per column, into shared memory
#pragma unroll 1
    for (int j = 0; j < 12; ++j) {
      Dual zd[12], gd[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) zd[i] = {z[i], i == j ? 1.0f : 0.0f};
      Dual ihd;
      grad3<Dual>(zd, cells, dxpu, fr, k, gd, ihd);
      const float frj = __ldg(free_in + j * n + e);
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        if (i < j) continue;
        float h = gd[i].d * fr[i] * frj;
        if (i == j) h = h + (1.0f - fr[i]) + kLevenberg;
        H[tri(i, j) * kThreads] = h;
      }
    }
    float nb[12], p[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) nb[i] = -g[i];
    ldlt12(H, nb, p);
    bool finite = true;
#pragma unroll
    for (int i = 0; i < 12; ++i) finite = finite && isfinite(p[i]);
    if (!finite) {
#pragma unroll
      for (int i = 0; i < 12; ++i) p[i] = -g[i] * k.inv_w2;
    }

    // backtracking: the largest accepted alpha, 0 if none
    float det0 = edet3(z);
    float det_floor = det0 < 0.0f ? det0 : (det0 != det0 ? det0 : 0.0f);
    float alpha = 0.0f;
#pragma unroll 1
    for (int a = 0; a < 5; ++a) {
      float zt[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) zt[i] = z[i] + alphas[a] * p[i];
      float e_t = energy3(zt, cells, dxpu, k);
      bool ok = isfinite(e_t) && e_t <= e0 && edet3(zt) > det_floor;
      if (ok) alpha = alphas[a];
    }
    float pmax = fabsf(p[0]), zmax = fabsf(z[0]);
#pragma unroll
    for (int i = 1; i < 12; ++i) {
      pmax = maxnan(pmax, fabsf(p[i]));
      zmax = maxnan(zmax, fabsf(z[i]));
    }
    float step_inf = alpha * pmax;
    bool stalled = step_inf <= eps_stall * (1.0f + zmax);
    // retire on a small gradient from the second sweep on, before moving
    if (it > 0 && gnorm < k.tol) break;
#pragma unroll
    for (int i = 0; i < 12; ++i) z[i] = z[i] + alpha * p[i];
    if (stalled) break;
  }
#pragma unroll
  for (int c = 0; c < 12; ++c) zout[c * n + e] = z[c];
}

}  // namespace

// consts: the 18 floats of Consts3 in order (Ehat row-major, w^2, w^2/2,
// 1/w^2, tol, then the five f32 constants of ops/prox3d.py)
extern "C" int mm_prox3d(const float* z, const float* dxpu, const float* free_,
                         const float* cells, float* zout, float* ih0, long long n,
                         const float* consts, int max_iters, void* stream) {
  if (n <= 0) return 0;
  Consts3 k;
  std::memcpy(&k, consts, sizeof(k));
  const long long blocks = (n + kThreads - 1) / kThreads;
  prox3d_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      z, dxpu, free_, cells, zout, ih0, n, k, max_iters);
  return (int)cudaGetLastError();
}
