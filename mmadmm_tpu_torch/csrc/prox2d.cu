// K1: the 2D ADMM prox z-update, its inputs staged on chip.
//
// Replaces mmadmm_tpu/ops/prox_pallas2d.py::make_prox_pallas2d (:573; its
// kernel _make_kernel :601, the component-form sweep newton_sweeps_c :451,
// pl.pallas_call :671). For each element it runs up to max_iters
// damped-Newton sweeps on
//     I_h(z) + 0.5 w^2 |dxpu - z|^2
// with the analytic Huang gradient, the 6x6 Hessian as the forward
// derivative of that gradient (dual numbers), an unrolled LDL^T solve with
// the -g/w^2 fallback, and 5 backtracking trials. The plain PyTorch
// version in ops/prox2d.py performs the same operations in the same order;
// built with --fmad=false the two agree bit for bit.
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
// writes 7 (292 bytes in float, 584 in double: 0.036 and 0.071 ms for the
// 409,600 slots of Shoulder-320 at 3.35 TB/s), but a sweep that goes on to
// its step does several thousand operations (the Hessian's dual passes take
// most of them), at half the float rate in double, and elements take 1 to
// max_iters sweeps: 3.75e9 operations at Shoulder-320 step 0, 0.056 ms at
// 67 TFLOP/s in float, 0.113 ms at 33.5 in double (chip_smoke.py counts
// them; those rates count a fused multiply-add as two operations, and a
// --fmad=false build issues none).
//
// The first design, one thread per element with its whole state in
// registers (the 48 cell channels, z, dxpu, free, the 21-entry triangle
// and the factor), took 255 registers (and in double 1.3 KB of stack and
// 1.5/4.0 KB of spills), so an SM held 8 warps; it retired on a small
// gradient only after the Hessian, solve and trials it then discarded (the
// JAX order: a TPU tile moves as one), and it tried all five step sizes.
// This design, still one thread per element:
//   - a block stages its elements' inputs (z, dxpu, free and the 48 cell
//     channels, 66 values an element) into shared memory once, with
//     cp.async (stage.cuh, shared with prox3d.cu), and every evaluation
//     reads the cells from there (huang2d.cuh's SharedRows: the elements
//     of a warp on consecutive words), so a thread keeps only z and the
//     sweep's state;
//   - a sweep first computes the gradient and retires on a small one (from
//     the second sweep on) before anything else: such an element leaves
//     without moving, so the Hessian, solve and trials the JAX order
//     computes first would be thrown away (200,787 of 788,620
//     element-sweeps at Shoulder-320 step 0 in float); the first gradient
//     also gives ih0 (the same operations as the energy at the input);
//   - the step sizes are tried from the largest down, and the first
//     accepted one is the step: the sequential loop keeps the largest
//     accepted of all five, so it is the same alpha, and a sweep whose
//     full step is accepted evaluates one trial energy instead of five;
//   - the Hessian's columns come from dual passes of N columns each
//     (dual.cuh's DualN: each column's bits are those of a pass of its
//     own), into a triangle in registers or in shared memory.
// Chosen per real type by timing on the H100 (scripts/cuda_k1_variants.py
// times them at the step-0 inputs of Shoulder-320 in float and double and
// of Monitor3320r in float; PERF.md has the times):
//   - one thread an element in both types: groups of 2, 3 and 6 lanes an
//     element, which spread the Hessian's passes and the trials, repeat the
//     gradient, the solve and the tests on every lane, which a shorter
//     sweep does not repay (1.2x, 1.4x and 1.9x the one-thread time in
//     float); a block queue (a group taking its next element when its own
//     is done, in fewer threads) and caps at 144 registers and below are
//     slower still. Those variants live in the script, not here;
//   - in float one column a pass, the six passes unrolled into a triangle
//     in registers, capped at 168 registers (316 bytes of spills; 12 warps
//     an SM): the passes are independent, and unrolled they overlap; 7 %
//     faster at Shoulder-320 and 17 % at Monitor3320r than the 110-register
//     build that runs them one by one into its triangle in shared memory,
//     whose stores order the next pass's loads of the staged cells (the
//     compiler cannot tell them apart; unrolled by 2 or 3 so, it is
//     1.1-1.3x slower still);
//   - in double two columns a pass, run one by one into the triangle in
//     shared memory, no cap (255 registers, 96 bytes of spills): the value
//     part of a dual pass is computed three times instead of six, 6 %
//     faster than one column a pass (208 registers, no spill); unrolling or
//     capping spills kilobytes in double and is 1.3-4x slower.

#include "huang2d.cuh"
#include "stage.cuh"

namespace {

constexpr int kTri = 21;    // entries of the lower triangle of a 6x6 matrix
constexpr int kCells = 48;  // cell channels per element

// the Hessian's columns a dual pass (dividing 6); whether the passes run
// unrolled into a triangle in registers, else one by one into the element's
// triangle in shared memory; and the registers a thread may take (255: no
// cap), which set the blocks an SM must hold: 65,536 / (kK1Threads x kK1Regs)
template <typename R>
constexpr int kK1Tangents = sizeof(R) == 4 ? 1 : 2;
template <typename R>
constexpr bool kK1Registers = sizeof(R) == 4;
template <typename R>
constexpr int kK1Regs = sizeof(R) == 4 ? 168 : 255;

// A block stages the inputs of its 64 elements, one a thread: at most 44,552
// bytes in double (87 values an element: the 66 inputs and the 21-entry
// triangle), inside the 48 KB of static shared memory a block may have.
constexpr int kK1Threads = 64;

// A block's staged inputs for kE elements, the cells [channel][element]
// (SharedRows), the rest [element][channel], and kH Hessian triangles.
template <typename R, int kE, int kH>
struct Stage {
  R cells[kCells * kE];
  R z[kE * 6], dxpu[kE * 6], fr[kE * 6];
  R hess[kH * kTri + 1];
};

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// NaN-propagating max (torch.maximum)
template <typename R>
__device__ __forceinline__ R maxnan(R a, R b) { return (a > b || a != a) ? a : b; }

template <typename R>
__device__ __forceinline__ R edet(const R* z) {
  return (z[2] - z[0]) * (z[5] - z[1]) - (z[4] - z[0]) * (z[3] - z[1]);
}

// H x = b with H's lower triangle in H[tri(i, j)] (i >= j)
template <typename R>
__device__ __forceinline__ void ldlt(const R* H, const R* b, R* x) {
  R L[6][6];
  R D[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    R d = H[tri(j, j)];
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - L[j][k] * L[j][k] * D[k];
    d = abs_(d) < Num<R>::kDiagFloor ? Num<R>::kDiagFloor : d;
    D[j] = d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      R s = H[tri(i, j)];
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

// columns j0 .. j0 + N - 1 of the lower triangle of the Hessian at z (rows
// i >= j), from one dual pass with N tangents: each column's bits are those
// of a pass of its own (dual.cuh's DualN)
template <int N, typename C, typename R>
__device__ __forceinline__ void hess_cols(int j0, const R* z, C cells, const R* dxpu,
                                          const R* fr, const Consts<R>& k, R* H) {
  DualN<R, N> zd[6], gd[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    zd[i].v = z[i];
#pragma unroll
    for (int t = 0; t < N; ++t) zd[i].d[t] = i == j0 + t ? R(1) : R(0);
  }
  DualN<R, N> ihd;
  grad<DualN<R, N>>(zd, cells, dxpu, fr, k, gd, ihd);
#pragma unroll
  for (int t = 0; t < N; ++t) {
    const int j = j0 + t;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (i < j) continue;
      R h = gd[i].d[t] * fr[i] * fr[j];
      if (i == j) h = h + (R(1) - fr[i]) + Num<R>::kLevenberg;
      H[tri(i, j)] = h;
    }
  }
}

// the backtracking step sizes 1/16, 1/8, 1/4, 1/2, 1: 2^(a - 4), exact
template <typename R>
__device__ __forceinline__ R alpha_bt(int a) { return R(0.0625) * (R)(1 << a); }

// backtracking from the largest step down: the first accepted alpha, 0 if
// none, is the largest accepted, which the sequential loop of
// ops/newton.py::_backtrack returns after trying every alpha. A trial is
// accepted at a finite energy not above e0 whose orientation determinant
// stays above det_floor.
template <typename C, typename R>
__device__ __forceinline__ R backtrack(const R* z, const R* p, C cells, const R* dxpu,
                                       const Consts<R>& k, R e0, R det_floor) {
#pragma unroll 1
  for (int a = 4; a >= 0; --a) {
    R zt[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) zt[i] = z[i] + alpha_bt<R>(a) * p[i];
    R ih_t, e_t;
    energy(zt, cells, dxpu, k, ih_t, e_t);
    if (isfinite(e_t) && e_t <= e0 && edet(zt) > det_floor) return alpha_bt<R>(a);
  }
  return R(0);
}

// Newton sweeps in the JAX order, except that a sweep retires on its
// gradient before it builds the Hessian (see the note at the top).
template <typename R>
__global__ void __launch_bounds__(kK1Threads, 65536 / (kK1Threads * kK1Regs<R>))
    prox2d_kernel(const R* __restrict__ z_in, const R* __restrict__ dxpu_in,
                  const R* __restrict__ free_in, const R* __restrict__ cells_in,
                  R* __restrict__ zout, R* __restrict__ ih0_out, long long n, Consts<R> k,
                  int max_iters) {
  constexpr int kE = kK1Threads, N = kK1Tangents<R>;
  static_assert(6 % N == 0, "the Hessian's six columns in passes of N");
  __shared__ __align__(16) Stage<R, kE, kK1Registers<R> ? 0 : kE> st;
  const long long first = (long long)blockIdx.x * kE;
  stage_rows<kE, kE>(st.cells, cells_in, kCells, n, first);
  stage_cols<kE, kE>(st.z, z_in, 6, n, first);
  stage_cols<kE, kE>(st.dxpu, dxpu_in, 6, n, first);
  stage_cols<kE, kE>(st.fr, free_in, 6, n, first);
  copies_done();
  __syncthreads();  // the block's only barrier

  const int el = threadIdx.x;
  const long long e = first + el;
  if (e >= n) return;
  const SharedRows<R, kE> cells{st.cells + el};
  const R* dxpu = st.dxpu + el * 6;
  const R* fr = st.fr + el * 6;
  R z[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) z[c] = st.z[el * 6 + c];

  if (max_iters <= 0) ih0_out[e] = energy_unreg(z, cells, k);
  for (int it = 0; it < max_iters; ++it) {
    // gradient, its norm and the regularized energy at the start
    R g[6];
    R ih;
    const R e0 = grad<R>(z, cells, dxpu, fr, k, g, ih);
    if (it == 0) ih0_out[e] = ih;  // the unregularized energy at the input
    R gnorm = abs_(g[0]);
#pragma unroll
    for (int i = 1; i < 6; ++i) gnorm = gnorm + abs_(g[i]);
    // retire on a small gradient from the second sweep on, before moving
    // and before the Hessian, which such an element would not use
    if (it > 0 && gnorm < k.tol) break;

    // the Hessian's columns in passes of N columns, then the step
    R nb[6], p[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) nb[i] = -g[i];
    if constexpr (kK1Registers<R>) {
      R H[kTri];
#pragma unroll
      for (int j0 = 0; j0 < 6; j0 += N) hess_cols<N>(j0, z, cells, dxpu, fr, k, H);
      ldlt(H, nb, p);
    } else {
      R* H = st.hess + el * kTri;
#pragma unroll 1
      for (int j0 = 0; j0 < 6; j0 += N) hess_cols<N>(j0, z, cells, dxpu, fr, k, H);
      ldlt(H, nb, p);
    }
    bool finite = true;
#pragma unroll
    for (int i = 0; i < 6; ++i) finite = finite && isfinite(p[i]);
    if (!finite) {
#pragma unroll
      for (int i = 0; i < 6; ++i) p[i] = -g[i] * k.inv_w2;
    }

    const R det0 = edet(z);
    const R det_floor = det0 < R(0) ? det0 : (det0 != det0 ? det0 : R(0));
    const R alpha = backtrack(z, p, cells, dxpu, k, e0, det_floor);
    R pmax = abs_(p[0]), zmax = abs_(z[0]);
#pragma unroll
    for (int i = 1; i < 6; ++i) {
      pmax = maxnan(pmax, abs_(p[i]));
      zmax = maxnan(zmax, abs_(z[i]));
    }
    const R step_inf = alpha * pmax;
    const bool stalled = step_inf <= Num<R>::kEpsStall * (R(1) + zmax);
#pragma unroll
    for (int i = 0; i < 6; ++i) z[i] = z[i] + alpha * p[i];
    if (stalled) break;
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) zout[c * n + e] = z[c];  // z stays in registers
}

template <typename R>
int launch(const R* z, const R* dxpu, const R* free_, const R* cells, R* zout, R* ih0,
           long long n, Consts<R> k, int max_iters, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kK1Threads - 1) / kK1Threads;
  prox2d_kernel<R><<<(unsigned)blocks, kK1Threads, 0, (cudaStream_t)stream>>>(
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

// the block K1 launches with in float (f64 = 0) or double: shape[0]
// elements, one a thread; shape[1] Hessian columns a dual pass; shape[2] 1 if
// the passes run unrolled into a triangle in registers, 0 if one by one into
// shared memory
extern "C" void mm_prox2d_block(int f64, int* shape) {
  shape[0] = kK1Threads;
  shape[1] = f64 ? kK1Tangents<double> : kK1Tangents<float>;
  shape[2] = f64 ? kK1Registers<double> : kK1Registers<float>;
}
