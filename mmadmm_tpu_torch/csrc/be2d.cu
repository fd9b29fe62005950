// K2 and K3: the unregularized Huang gradient + energy (K2) and Hessian
// (K3) of every triangle, one thread per element slot.
//
// Replace the two kernels of mmadmm_tpu/ops/prox_pallas2d.py::
// make_be_kernels2d: eg_kernel (K2) and hess_kernel (K3). Both evaluate the
// prox's component math with w = 0, dxpu = 0 and free = 1: explicit and
// backward Euler mask at the node level, not per element.
//
// Both kernels are templates on the real type R: mm_eg2d and mm_hess2d
// launch them in float, mm_eg2d_f64 and mm_hess2d_f64 in double, as the
// JAX kernels build themselves in their inputs' dtype.
//
// Layout: channel-major [C, n] in R, channel stride n. z is [6, n]
// (channel v*2 + d), cells [48, n] (three 16-wide cell rows, see
// huang2d.cuh). K2 writes g [6, n] and ih [n]; K3 writes the lower
// triangle of the 6x6 Hessian, H[i][j] (i >= j) in channel
// i*(i+1)/2 + j of [21, n], with the 1e-9 Levenberg term on the diagonal.
// The plain PyTorch versions are ops/be2d.py::eg2d_plain / hess2d_plain;
// built with --fmad=false the kernels agree with them bit for bit.
//
// What bounds them on the H100: bytes. K2 reads 54 values and writes 7
// per slot (244 bytes in float, 488 in double) for about 390 operations;
// K3 reads the same 54 and writes 21 (300 bytes, 600 in double) for about
// 4,050 operations (counted on the plain versions by chip_smoke.py), below
// the card's 20 float32 operations per byte and its 10 float64 ones. K3
// repeats the value part of the gradient in each of its six dual-number
// passes, one per Hessian column, so it does more arithmetic than that
// count. Both keep a slot's state in registers; K3
// writes each column's entries as soon as its pass ends, so no 6x6 matrix
// is held.

#include "huang2d.cuh"

namespace {

template <typename R>
__device__ __forceinline__ void load_slot(const R* __restrict__ z_in,
                                          const R* __restrict__ cells_in, long long n,
                                          long long e, R* z, R* cells) {
#pragma unroll
  for (int c = 0; c < 6; ++c) z[c] = z_in[c * n + e];
#pragma unroll
  for (int c = 0; c < 48; ++c) cells[c] = cells_in[c * n + e];
}

template <typename R>
__global__ void __launch_bounds__(128) eg2d_kernel(
    const R* __restrict__ z_in, const R* __restrict__ cells_in,
    R* __restrict__ g_out, R* __restrict__ ih_out, long long n, Consts<R> k) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  R z[6], cells[48];
  load_slot(z_in, cells_in, n, e, z, cells);
  const R dxpu[6] = {R(0), R(0), R(0), R(0), R(0), R(0)};
  const R fr[6] = {R(1), R(1), R(1), R(1), R(1), R(1)};
  R g[6], ih;
  grad<R>(z, cells, dxpu, fr, k, g, ih);
#pragma unroll
  for (int c = 0; c < 6; ++c) g_out[c * n + e] = g[c];
  ih_out[e] = ih;
}

template <typename R>
__global__ void __launch_bounds__(128) hess2d_kernel(
    const R* __restrict__ z_in, const R* __restrict__ cells_in,
    R* __restrict__ h_out, long long n, Consts<R> k) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  R z[6], cells[48];
  load_slot(z_in, cells_in, n, e, z, cells);
  const R dxpu[6] = {R(0), R(0), R(0), R(0), R(0), R(0)};
  const R fr[6] = {R(1), R(1), R(1), R(1), R(1), R(1)};
  // column j of the Hessian from one dual pass along z_j, as K1 builds it
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    Dual<R> zd[6], gd[6], ihd;
#pragma unroll
    for (int i = 0; i < 6; ++i) zd[i] = {z[i], i == j ? R(1) : R(0)};
    grad<Dual<R>>(zd, cells, dxpu, fr, k, gd, ihd);
#pragma unroll
    for (int i = j; i < 6; ++i) {
      R h = gd[i].d * fr[i] * fr[j];
      if (i == j) h = h + (R(1) - fr[i]) + Num<R>::kLevenberg;
      h_out[(i * (i + 1) / 2 + j) * n + e] = h;
    }
  }
}

constexpr int kThreads = 128;

template <typename R>
int launch_eg(const R* z, const R* cells, R* g, R* ih, long long n, R h00, R h01, R h10, R h11,
              void* stream) {
  if (n <= 0) return 0;
  Consts<R> k{h00, h01, h10, h11, R(0), R(0), R(0), R(0)};
  const long long blocks = (n + kThreads - 1) / kThreads;
  eg2d_kernel<R><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(z, cells, g, ih, n, k);
  return (int)cudaGetLastError();
}

template <typename R>
int launch_hess(const R* z, const R* cells, R* h, long long n, R h00, R h01, R h10, R h11,
                void* stream) {
  if (n <= 0) return 0;
  Consts<R> k{h00, h01, h10, h11, R(0), R(0), R(0), R(0)};
  const long long blocks = (n + kThreads - 1) / kThreads;
  hess2d_kernel<R><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(z, cells, h, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mm_eg2d(const float* z, const float* cells, float* g, float* ih, long long n,
                       float h00, float h01, float h10, float h11, void* stream) {
  return launch_eg<float>(z, cells, g, ih, n, h00, h01, h10, h11, stream);
}

extern "C" int mm_hess2d(const float* z, const float* cells, float* h, long long n, float h00,
                         float h01, float h10, float h11, void* stream) {
  return launch_hess<float>(z, cells, h, n, h00, h01, h10, h11, stream);
}

extern "C" int mm_eg2d_f64(const double* z, const double* cells, double* g, double* ih,
                           long long n, double h00, double h01, double h10, double h11,
                           void* stream) {
  return launch_eg<double>(z, cells, g, ih, n, h00, h01, h10, h11, stream);
}

extern "C" int mm_hess2d_f64(const double* z, const double* cells, double* h, long long n,
                             double h00, double h01, double h10, double h11, void* stream) {
  return launch_hess<double>(z, cells, h, n, h00, h01, h10, h11, stream);
}
