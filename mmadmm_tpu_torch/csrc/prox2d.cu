// K1: the 2D ADMM prox z-update, one thread per triangle.
//
// Replaces mmadmm_tpu/ops/prox_pallas2d.py::make_prox_pallas2d (the
// component-form Pallas kernel _make_kernel / newton_sweeps_c). For each
// element it runs up to max_iters damped-Newton sweeps on
//     I_h(z) + 0.5 w^2 |dxpu - z|^2
// with the analytic Huang gradient, the 6x6 Hessian as the forward
// derivative of that gradient (dual numbers, one pass per column), an
// unrolled LDL^T solve with the -g/w^2 fallback, and 5 backtracking trials.
// The plain PyTorch version in ops/prox2d.py performs the same operations
// in the same order; built with --fmad=false the two agree bit for bit.
//
// The kernel is a template on the real type R: mm_prox2d launches it in
// float, mm_prox2d_f64 in double (the JAX kernel builds itself in the
// dtype of its inputs, and a float64 run's default dtype is float64). The
// double instantiation computes in double throughout, with the constants
// rounded as the JAX kernel rounds them in float64.
//
// Layout: channel-major [C, n] in R, channel stride n. z, dxpu, free are
// [6, n] (channel v*2 + d); cells is [48, n] (three 16-wide cell rows:
// v00, v10, v01, v11 as (m00, m01, m11), then x0, x1, y0, y1). Outputs:
// zout [6, n] and ih0 [n], the unregularized energy at the input z.
//
// What bounds it on the H100: arithmetic. An element reads 66 values and
// writes 7 (292 bytes in float, 584 in double; about 36 and 71 us for the
// 409,600 slots of Shoulder-320 at 3.35 TB/s), but each sweep does several
// thousand operations, at half the float rate in double
// (the Hessian's six dual passes take most of them), and elements take
// 1 to max_iters sweeps. The design answers that with one thread per
// element, each holding its whole state in registers and leaving the
// sweep loop as soon as it retires: nothing ties an element to its
// neighbours, so the TPU kernel's whole-tile early exit has no
// counterpart here. Warps whose threads need different sweep counts
// diverge; that is the first thing a faster version would address.

#include "huang2d.cuh"

namespace {

// NaN-propagating max (torch.maximum)
template <typename R>
__device__ __forceinline__ R maxnan(R a, R b) { return (a > b || a != a) ? a : b; }

template <typename R>
__device__ __forceinline__ R edet(const R* z) {
  return (z[2] - z[0]) * (z[5] - z[1]) - (z[4] - z[0]) * (z[3] - z[1]);
}

// H x = b with H's lower triangle in H[i*(i+1)/2 + j] (i >= j)
template <typename R>
__device__ __forceinline__ void ldlt(const R* H, const R* b, R* x) {
  R L[6][6];
  R D[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    R d = H[j * (j + 1) / 2 + j];
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - L[j][k] * L[j][k] * D[k];
    d = abs_(d) < Num<R>::kDiagFloor ? Num<R>::kDiagFloor : d;
    D[j] = d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      R s = H[i * (i + 1) / 2 + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k] * D[k];
      L[i][j] = s / d;
    }
  }
  R zv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    R s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * zv[k];
    zv[i] = s;
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    R s = zv[i] / D[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s;
  }
}

template <typename R>
__global__ void __launch_bounds__(128) prox2d_kernel(
    const R* __restrict__ z_in, const R* __restrict__ dxpu_in,
    const R* __restrict__ free_in, const R* __restrict__ cells_in,
    R* __restrict__ zout, R* __restrict__ ih0_out, long long n, Consts<R> k, int max_iters) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  R z[6], dxpu[6], fr[6], cells[48];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    z[c] = z_in[c * n + e];
    dxpu[c] = dxpu_in[c * n + e];
    fr[c] = free_in[c * n + e];
  }
#pragma unroll
  for (int c = 0; c < 48; ++c) cells[c] = cells_in[c * n + e];

  ih0_out[e] = energy_unreg(z, cells, k);
  // the backtracking step sizes 1/16, 1/8, 1/4, 1/2, 1 (exact in R)
  const R alphas[5] = {R(0.0625), R(0.125), R(0.25), R(0.5), R(1)};

  for (int it = 0; it < max_iters; ++it) {
    // gradient, its norm and the regularized energy at the start
    R g[6];
    R ih;
    R e0 = grad<R>(z, cells, dxpu, fr, k, g, ih);
    R gnorm = abs_(g[0]);
    for (int i = 1; i < 6; ++i) gnorm = gnorm + abs_(g[i]);

    // Hessian, lower triangle, one dual pass per column
    R H[21];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      Dual<R> zd[6], gd[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) zd[i] = {z[i], i == j ? R(1) : R(0)};
      Dual<R> ihd;
      grad<Dual<R>>(zd, cells, dxpu, fr, k, gd, ihd);
#pragma unroll
      for (int i = j; i < 6; ++i) {
        R h = gd[i].d * fr[i] * fr[j];
        if (i == j) h = h + (R(1) - fr[i]) + Num<R>::kLevenberg;
        H[i * (i + 1) / 2 + j] = h;
      }
    }
    R nb[6], p[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) nb[i] = -g[i];
    ldlt(H, nb, p);
    bool finite = true;
#pragma unroll
    for (int i = 0; i < 6; ++i) finite = finite && isfinite(p[i]);
    if (!finite) {
#pragma unroll
      for (int i = 0; i < 6; ++i) p[i] = -g[i] * k.inv_w2;
    }

    // backtracking: the largest accepted alpha, 0 if none
    R det0 = edet(z);
    R det_floor = det0 < R(0) ? det0 : (det0 != det0 ? det0 : R(0));
    R alpha = R(0);
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      R zt[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) zt[i] = z[i] + alphas[a] * p[i];
      R ih_t, e_t;
      energy(zt, cells, dxpu, k, ih_t, e_t);
      bool ok = isfinite(e_t) && e_t <= e0 && edet(zt) > det_floor;
      if (ok) alpha = alphas[a];
    }
    R pmax = abs_(p[0]), zmax = abs_(z[0]);
#pragma unroll
    for (int i = 1; i < 6; ++i) {
      pmax = maxnan(pmax, abs_(p[i]));
      zmax = maxnan(zmax, abs_(z[i]));
    }
    R step_inf = alpha * pmax;
    bool stalled = step_inf <= Num<R>::kEpsStall * (R(1) + zmax);
    // retire on a small gradient from the second sweep on, before moving
    if (it > 0 && gnorm < k.tol) break;
#pragma unroll
    for (int i = 0; i < 6; ++i) z[i] = z[i] + alpha * p[i];
    if (stalled) break;
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) zout[c * n + e] = z[c];
}

template <typename R>
int launch(const R* z, const R* dxpu, const R* free_, const R* cells, R* zout, R* ih0,
           long long n, Consts<R> k, int max_iters, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  prox2d_kernel<R><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      z, dxpu, free_, cells, zout, ih0, n, k, max_iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mm_prox2d(const float* z, const float* dxpu, const float* free_, const float* cells,
                         float* zout, float* ih0, long long n, float h00, float h01, float h10,
                         float h11, float w2, float half_w2, float inv_w2, float tol, int max_iters,
                         void* stream) {
  return launch<float>(z, dxpu, free_, cells, zout, ih0, n,
                       {h00, h01, h10, h11, w2, half_w2, inv_w2, tol}, max_iters, stream);
}

extern "C" int mm_prox2d_f64(const double* z, const double* dxpu, const double* free_,
                             const double* cells, double* zout, double* ih0, long long n,
                             double h00, double h01, double h10, double h11, double w2,
                             double half_w2, double inv_w2, double tol, int max_iters,
                             void* stream) {
  return launch<double>(z, dxpu, free_, cells, zout, ih0, n,
                        {h00, h01, h10, h11, w2, half_w2, inv_w2, tol}, max_iters, stream);
}
