// K2 and K3: the unregularized Huang gradient + energy (K2) and Hessian
// (K3) of every triangle.
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
// built with --fmad=false the kernels agree with them bit for bit (K3 up to
// the sign of an exact zero, which == and torch.equal do not see; see
// below).
//
// K2, one thread per element slot, is bound by bytes on the H100: it reads
// 54 values and writes 7 per slot (244 bytes in float, 488 in double) for
// about 390 operations, below the card's 20 float32 operations per byte
// and its 10 float64 ones.
//
// K3 reads the same 54 values and writes 21 (300 bytes, 600 in double), and
// its plain version counts about 4,050 operations a slot (chip_smoke.py
// counts them): one dual pass that carries all six Hessian columns. Its
// first design, one thread an element with its 54 inputs in registers, ran
// six dual passes of one column each, unrolled: 251 registers in float (8
// warps an SM), 255 and 1.3 KB of spills in double. Built with
// --fmad=false the card issues no fused multiply-add, so it runs at half
// the peak rates the bound assumes, and the arithmetic, the registers and
// the spills, not the bytes, bound K3. This design, still one thread an
// element:
//   - the block stages its elements' z and cells in shared memory once
//     with cp.async (stage.cuh, as K1 does), and the passes read the cells
//     there (huang2d.cuh's SharedRows), so 48 values leave each thread's
//     registers;
//   - a pass samples the monitor at the vertices that its column does not
//     move as plain values: column j moves only z_j, of vertex j / 2, and the
//     sample of a vertex depends on that vertex's z alone, so the tangents
//     that pass through the other two samples are exact zeros (their sign
//     aside) and are not computed;
//   - the gradient's regularization and mask (w = 0, dxpu = 0, free = 1),
//     which only add zeros and multiply by one, are left out (raw_grad);
//   - in float the six passes run unrolled under a cap of 168 registers (3
//     blocks of 128, 12 warps an SM, no spill); in double they run one by
//     one in a loop (248 registers, no spill), a block of 32.
// scripts/cuda_k3_variants.py times this design, the first one and the
// other layouts, which it generates beside this source, against each other
// (PERF.md has the times). What lost: N > 1
// columns a dual pass (dual.cuh's DualN, whose columns keep their bits),
// which computes the value part 6 / N times instead of six but holds N
// tangents of every intermediate at once (in double it spills
// kilobytes); groups of 2, 3 or 6 lanes an element, each lane taking
// 6 / G columns, which repeat the value part on every lane; the cells kept
// in registers or read from device memory where used; caps of 128-144
// registers in float, and any cap in double.

#include "huang2d.cuh"
#include "stage.cuh"

namespace {

constexpr int kCells = 48;  // cell channels per element

__device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

template <typename R>
__device__ __forceinline__ void load_slot(const R* __restrict__ z_in,
                                          const R* __restrict__ cells_in, long long n,
                                          long long e, R* z, R* cells) {
#pragma unroll
  for (int c = 0; c < 6; ++c) z[c] = z_in[c * n + e];
#pragma unroll
  for (int c = 0; c < kCells; ++c) cells[c] = cells_in[c * n + e];
}

template <typename R>
__global__ void __launch_bounds__(128) eg2d_kernel(
    const R* __restrict__ z_in, const R* __restrict__ cells_in,
    R* __restrict__ g_out, R* __restrict__ ih_out, long long n, Consts<R> k) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  R z[6], cells[kCells];
  load_slot(z_in, cells_in, n, e, z, cells);
  const R dxpu[6] = {R(0), R(0), R(0), R(0), R(0), R(0)};
  const R fr[6] = {R(1), R(1), R(1), R(1), R(1), R(1)};
  R g[6], ih;
  grad<R>(z, cells, dxpu, fr, k, g, ih);
#pragma unroll
  for (int c = 0; c < 6; ++c) g_out[c * n + e] = g[c];
  ih_out[e] = ih;
}

// K3's launch in each real type (scripts/cuda_k3_variants.py times the
// others): threads a block, one an element; the registers a thread may take
// (255: no cap), which set the blocks an SM must hold, 65,536 / (threads x
// registers); and whether the six passes run one by one in a loop (else
// unrolled).
template <typename R>
constexpr int kK3Threads = sizeof(R) == 4 ? 128 : 32;
template <typename R>
constexpr int kK3Regs = sizeof(R) == 4 ? 168 : 255;
template <typename R>
constexpr bool kK3Rolled = sizeof(R) == 8;

// The monitor samples of the dual pass along z_j: the sample of vertex
// j / 2, which z_j moves, with its tangent, and the other two as plain values
// with zero tangents, which a full dual pass computes for them up to the sign
// of a zero. In a loop of passes j is known only at run time, so the tangents
// go in place by selects; unrolled, they fold.
template <typename C, typename R>
__device__ __forceinline__ void sparse_samples(int j, const R* z, C cells,
                                               Common<Dual<R>>& t) {
  const int v = j / 2;
  const Dual<R> x = {v == 0 ? z[0] : (v == 1 ? z[2] : z[4]), j % 2 == 0 ? R(1) : R(0)};
  const Dual<R> y = {v == 0 ? z[1] : (v == 1 ? z[3] : z[5]), j % 2 == 1 ? R(1) : R(0)};
  Dual<R> s[3];
  sample_m(cells + 16 * v, x, y, s[0], s[1], s[2]);
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    R p[3];
    sample_m(cells + 16 * u, z[2 * u], z[2 * u + 1], p[0], p[1], p[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c)  // v's value too: its dual sample's value has the same bits
      t.m[u][c] = {p[c], u == v ? s[c].d : R(0)};
  }
}

// Column j of the Hessian's lower triangle at z, from one dual pass along
// z_j, into H[i][j] (i >= j) of element e
template <typename C, typename R>
__device__ __forceinline__ void hess_column(int j, const R* z, C cells, const Consts<R>& k,
                                            R* __restrict__ h_out, long long n, long long e) {
  Dual<R> zd[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) zd[i] = {z[i], i == j ? R(1) : R(0)};
  Common<Dual<R>> t;
  sparse_samples(j, z, cells, t);
  common_tail(zd, k, t);
  Dual<R> raw[6];
  raw_grad(t, raw);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    if (i < j) continue;
    const R h = raw[i].d;
    h_out[tri(i, j) * n + e] = i == j ? h + Num<R>::kLevenberg : h;
  }
}

template <typename R>
__global__ void __launch_bounds__(kK3Threads<R>, 65536 / (kK3Threads<R> * kK3Regs<R>))
    hess2d_kernel(const R* __restrict__ z_in, const R* __restrict__ cells_in,
                  R* __restrict__ h_out, long long n, Consts<R> k) {
  constexpr int kE = kK3Threads<R>;  // elements a block
  __shared__ __align__(16) R cells_s[kCells * kE];
  __shared__ __align__(16) R z_s[6 * kE];
  const long long first = (long long)blockIdx.x * kE;
  stage_rows<kE, kE>(cells_s, cells_in, kCells, n, first);
  stage_rows<kE, kE>(z_s, z_in, 6, n, first);
  copies_done();
  __syncthreads();
  const int el = threadIdx.x;
  const long long e = first + el;
  if (e >= n) return;
  const SharedRows<R, kE> cells{cells_s + el};
  R z[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) z[c] = z_s[c * kE + el];
  if constexpr (kK3Rolled<R>) {
#pragma unroll 1
    for (int j = 0; j < 6; ++j) hess_column(j, z, cells, k, h_out, n, e);
  } else {
#pragma unroll
    for (int j = 0; j < 6; ++j) hess_column(j, z, cells, k, h_out, n, e);
  }
}

template <typename R>
int launch_eg(const R* z, const R* cells, R* g, R* ih, long long n, R h00, R h01, R h10, R h11,
              void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 128;
  Consts<R> k{h00, h01, h10, h11, R(0), R(0), R(0), R(0)};
  const long long blocks = (n + kThreads - 1) / kThreads;
  eg2d_kernel<R><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(z, cells, g, ih, n, k);
  return (int)cudaGetLastError();
}

template <typename R>
int launch_hess(const R* z, const R* cells, R* h, long long n, R h00, R h01, R h10, R h11,
                void* stream) {
  if (n <= 0) return 0;
  constexpr int kE = kK3Threads<R>;
  Consts<R> k{h00, h01, h10, h11, R(0), R(0), R(0), R(0)};
  const long long blocks = (n + kE - 1) / kE;
  hess2d_kernel<R><<<(unsigned)blocks, kE, 0, (cudaStream_t)stream>>>(z, cells, h, n, k);
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

// K3's block in float (f64 = 0) or double: shape = {elements, threads}
extern "C" void mm_hess2d_block(int f64, int* shape) {
  shape[0] = shape[1] = f64 ? kK3Threads<double> : kK3Threads<float>;
}
