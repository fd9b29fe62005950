// K2 and K3: the unregularized Huang gradient + energy (K2) and Hessian
// (K3) of every triangle, one thread per element slot.
//
// Replace the two kernels of mmadmm_tpu/ops/prox_pallas2d.py::
// make_be_kernels2d: eg_kernel (K2) and hess_kernel (K3). Both evaluate the
// prox's component math with w = 0, dxpu = 0 and free = 1: explicit and
// backward Euler mask at the node level, not per element.
//
// Layout: channel-major [C, n] float32, channel stride n. z is [6, n]
// (channel v*2 + d), cells [48, n] (three 16-wide cell rows, see
// huang2d.cuh). K2 writes g [6, n] and ih [n]; K3 writes the lower
// triangle of the 6x6 Hessian, H[i][j] (i >= j) in channel
// i*(i+1)/2 + j of [21, n], with the 1e-9 Levenberg term on the diagonal.
// The plain PyTorch versions are ops/be2d.py::eg2d_plain / hess2d_plain;
// built with --fmad=false the kernels agree with them bit for bit.
//
// What bounds them on the H100: bytes. K2 reads 54 floats and writes 7
// per slot (244 bytes) for about 390 float operations; K3 reads the same
// 54 and writes 21 (300 bytes) for about 4,050 operations (counted on the
// plain versions by chip_smoke.py), both below the card's 20 float32
// operations per byte. K3 repeats the value part of the gradient in each
// of its six dual-number passes, one per Hessian column, so it does more
// arithmetic than that count. Both keep a slot's state in registers; K3
// writes each column's entries as soon as its pass ends, so no 6x6 matrix
// is held.

#include "huang2d.cuh"

namespace {

__device__ __forceinline__ void load_slot(const float* __restrict__ z_in,
                                          const float* __restrict__ cells_in, long long n,
                                          long long e, float* z, float* cells) {
#pragma unroll
  for (int c = 0; c < 6; ++c) z[c] = z_in[c * n + e];
#pragma unroll
  for (int c = 0; c < 48; ++c) cells[c] = cells_in[c * n + e];
}

__global__ void __launch_bounds__(128) eg2d_kernel(
    const float* __restrict__ z_in, const float* __restrict__ cells_in,
    float* __restrict__ g_out, float* __restrict__ ih_out, long long n, Consts k) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float z[6], cells[48];
  load_slot(z_in, cells_in, n, e, z, cells);
  const float dxpu[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const float fr[6] = {1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f};
  float g[6], ih;
  grad<float>(z, cells, dxpu, fr, k, g, ih);
#pragma unroll
  for (int c = 0; c < 6; ++c) g_out[c * n + e] = g[c];
  ih_out[e] = ih;
}

__global__ void __launch_bounds__(128) hess2d_kernel(
    const float* __restrict__ z_in, const float* __restrict__ cells_in,
    float* __restrict__ h_out, long long n, Consts k) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float z[6], cells[48];
  load_slot(z_in, cells_in, n, e, z, cells);
  const float dxpu[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const float fr[6] = {1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f};
  // column j of the Hessian from one dual pass along z_j, as K1 builds it
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    Dual zd[6], gd[6], ihd;
#pragma unroll
    for (int i = 0; i < 6; ++i) zd[i] = {z[i], i == j ? 1.0f : 0.0f};
    grad<Dual>(zd, cells, dxpu, fr, k, gd, ihd);
#pragma unroll
    for (int i = j; i < 6; ++i) {
      float h = gd[i].d * fr[i] * fr[j];
      if (i == j) h = h + (1.0f - fr[i]) + kLevenberg;
      h_out[(i * (i + 1) / 2 + j) * n + e] = h;
    }
  }
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int mm_eg2d(const float* z, const float* cells, float* g, float* ih, long long n,
                       float h00, float h01, float h10, float h11, void* stream) {
  if (n <= 0) return 0;
  Consts k{h00, h01, h10, h11, 0.0f, 0.0f, 0.0f, 0.0f};
  const long long blocks = (n + kThreads - 1) / kThreads;
  eg2d_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(z, cells, g, ih, n, k);
  return (int)cudaGetLastError();
}

extern "C" int mm_hess2d(const float* z, const float* cells, float* h, long long n, float h00,
                         float h01, float h10, float h11, void* stream) {
  if (n <= 0) return 0;
  Consts k{h00, h01, h10, h11, 0.0f, 0.0f, 0.0f, 0.0f};
  const long long blocks = (n + kThreads - 1) / kThreads;
  hess2d_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(z, cells, h, n, k);
  return (int)cudaGetLastError();
}
