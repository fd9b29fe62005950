// K4, K4' and K4'': the 3D ADMM prox z-update.
//
// K4 replaces mmadmm_tpu/ops/prox_pallas3d.py::make_prox_pallas3d (:263, its
// pl.pallas_call at :418) with chord=False, comp_mesh=False. For each
// element it runs up to max_iters damped-Newton sweeps on
//     I_h(z) + 0.5 w^2 |dxpu - z|^2
// with the analytic Huang gradient, the 12x12 Hessian as the forward
// derivative of that gradient (dual numbers, one pass per column), an
// unrolled LDL^T solve with the -g/w^2 fallback, and 5 backtracking trials
// (the sweep of mmadmm_tpu/ops/prox_pallas2d.py::make_newton_sweeps,
// :298-359).
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
// The kernels are templates on the real type R, and each is built in float
// and in double (mm_prox3d and mm_prox3d_f64, mm_prox3d_chord_comp and
// mm_prox3d_chord_comp_f64, ...), as the JAX kernel builds itself in its
// inputs' dtype. A double build computes in double throughout, with the
// constants rounded as the JAX kernel rounds them in float64 (R(...)
// literals, the sqrt_/abs_ overloads and Num<R> of dual.cuh: no double is
// rounded through float).
//
// Layout: channel-major [C, n] in R, channel stride n. z, dxpu, free are
// [12, n] (channel v*3 + d); cells is [216, n]: per vertex, its cell's 8
// corners as (m00, m01, m02, m11, m12, m22), then x0, x1, y0, y1, z0, z1;
// K4' and K4''b also read ehat [9, n], row-major [d][j] = xi_{j+1, d} -
// xi_{0, d}.
// Outputs: zout [12, n] and ih0 [n], the unregularized energy at the input.
//
// What bounds them on the H100: arithmetic. A K4 element reads 252 values
// and writes 13, (3*12 + 216 + 12 + 1) * 4 = 1,060 bytes in float (2,120
// in double): 814 MB, 0.243 ms at 3.35 TB/s for the 768,000 slots of a
// 40^3 box mesh (0.486 ms in double); a K4' or K4''b element reads 9 more,
// 1,096 bytes (2,192 in double). A Newton sweep that goes on to its
// step does tens of thousands of float operations (the twelve dual passes
// of the Hessian take most of them; the op counter of chip_smoke.py on the
// plain versions gives the count for the inputs at hand); one that retires
// on its gradient costs one gradient. A chord sweep that keeps its cached
// step costs one gradient, one solve and one trial energy, a few thousand
// operations; that is what chord sweeps save on weakly regularized runs
// (rho = 10 in the 3DMonitor3 family), whose elements stay active for many
// sweeps.
//
// The Newton sweeps (K4, K4''b: prox3d_newton_kernel) run on a group of
// kGroup lanes per element, with the element's whole sweep state on the
// chip: with one thread per element, the 216 cell channels are read again
// from L2 by each of the ~18 evaluations of a sweep and the Newton state
// spills to local memory (168-255 registers, 1.8-2.7 KB of stack a thread),
// and the card waits on memory at about 2.5 % of the operations bound. So:
//   - a block stages its elements' inputs (z, dxpu, free, the 216 cell
//     channels and, for K4''b, Ehat: about 1 KB an element) into shared
//     memory once, with cp.async (16-byte copies where a channel row is
//     16-byte aligned and whole, 4-byte copies elsewhere, so any n works),
//     and every evaluation reads them from there;
//   - a sweep first computes the gradient and retires on a small one (from
//     the second sweep on) before anything else: such an element leaves
//     without moving, so the Hessian, solve and trials that the JAX order
//     computes first would be thrown away (44-50 % of the element-sweeps on
//     step-0 inputs);
//   - the twelve dual passes of the Hessian are spread over the group, lane
//     l taking the columns l, l + kGroup, ..., each written to the
//     element's 78-entry triangle in shared memory; each column's pass is
//     the one-thread design's pass, so its bits do not change;
//   - every lane then factors and solves that triangle in its registers,
//     in the one order of factor12 and direction, so every lane holds the
//     same step p (on a SIMT warp, redundant work costs the group what one
//     lane doing it alone would, and needs no broadcast);
//   - the five backtracking trials are spread over the lanes, and a ballot
//     of the group gives the largest accepted alpha, which is what the
//     sequential loop returns;
//   - the gradient, the retire and stall tests and the fallback are
//     computed by every lane from the same data, so every lane of a group
//     takes the same branch; a group synchronizes on its own mask
//     (__syncwarp, __ballot_sync), and a block only once, after staging.
// kGroup and the blocks an SM holds are chosen by timing
// (scripts/cuda_k4_variants.py, which times 4, 8 and 16 lanes and the
// register caps against the one-thread-per-element design): see the note at
// kGroup below.
//
// The chord sweeps (K4', K4''a: prox3d_chord_kernel) have the same on-chip
// design, with their own sweep: one Hessian per element at entry, factored
// once; the factored triangle (L and D) is the element's chord cache, kept
// in the block's shared memory (the Newton kernels' `hess`) from entry to
// the element's last sweep (the JAX kernel caches H and factors it again
// every sweep; factoring the same H gives the same L and D, so solving
// with the cached factors gives the same bits). So:
//   - the block stages its elements' inputs as the Newton kernels do
//     (and, for K4', Ehat);
//   - the entry Hessian's twelve dual passes are spread over the group as
//     in the Newton kernels, then one lane factors the triangle in place;
//   - a common sweep is the gradient, the retire test (from the second
//     sweep on), the solve with the cached factors (out of line, see
//     cached_direction) and one trial at alpha 1, all computed by every
//     lane from the same data (little in it can be shared out, and so every
//     lane takes the same branch with no broadcast);
//   - only a rejected trial refreshes: the columns again over the group
//     into the cache, the factor, the solve and the five trials over the
//     group (the ballot of backtrack_group);
//   - the element's first gradient also gives ih0: it is the same float
//     operations as the energy at the input.
// A refresh is guarded per element: a group that keeps its cached step skips
// it (though its lanes idle while another group of its warp refreshes). The
// group width, the register cap and the factor's lanes were chosen by timing
// (scripts/cuda_k4_variants.py): see kChordGroup below.

#include <cstring>

#include "huang3d.cuh"
#include "stage.cuh"

namespace {

static_assert(sizeof(Consts3<float>) == 9 * sizeof(float), "Consts3 is 9 packed values");
static_assert(sizeof(Consts3<double>) == 9 * sizeof(double), "Consts3 is 9 packed values");

constexpr int kTri = 78;       // entries of the lower triangle of a 12x12 matrix
constexpr int kCells = 216;    // cell channels per element

// Threads per block of the Newton kernels: 128 in float (32 elements at
// kGroup = 4), 64 in double. A block stages its elements' inputs and Hessian
// triangles, 330 values an element (NewtonStage): 32 elements take 42.3 KB
// in float but would take 84.5 KB in double, over the 48 KB of static
// shared memory a block may have; 16 take 42.2 KB. (Dynamic shared memory
// allows 32, with cudaFuncSetAttribute; scripts/cuda_k4_variants.py
// newton64 times that block against this one.)
template <typename R>
constexpr int kNewtonThreads = sizeof(R) == 4 ? 128 : 64;
constexpr int kThreads = kNewtonThreads<float>;

// Lanes per element in the Newton sweeps, and the blocks of kThreads an SM
// must hold at once, which caps the registers at 65,536 / (kThreads x
// blocks): 128 for K4, 168 for K4''b. Of the variants that
// scripts/cuda_k4_variants.py times on the H100 at the step-0 inputs of 3D
// Shoulder-40 (K4) and CompSquare-40 (K4''b), these are the fastest (PERF.md
// has the times): 4 lanes beat 8 and 16, whose lanes idle longer in the
// gradient, factor and solve (and 16 spill); with no cap both take 220-222
// registers and 2 blocks an SM, and the cap's few hundred bytes of spills
// cost less than the warps it adds. In double the blocks are of 64
// threads, so the same minimums of 4 (K4) and 3 (K4''b) blocks an SM leave
// up to 255 registers, which the double state (twice the float one's)
// needs; shared memory would hold 5 such blocks an SM.
constexpr int kGroup = 4;
constexpr int kBlocks = 4;      // K4
constexpr int kBlocksComp = 3;  // K4''b

// The chord sweeps: kChordE<R> elements a block, kChordGroup lanes each (a
// block of kChordE<R> x kChordGroup threads, with the Newton kernels' staging
// of 42-44 KB), and no register cap. The stage (NewtonStage) holds the
// inputs and the 78-entry chord cache of each element: 43,392 bytes for 32
// float elements and for 16 double ones; 32 double ones would take 86.8 KB,
// over the 48 KB of static shared memory a block may have, so a double
// block has 16 elements (at 2 lanes, one warp). Of the variants that
// scripts/cuda_k4_variants.py times on the H100 at the step-0 inputs of 3D
// CompSquare-40 (K4') and 3D SquareGrid-40 with prox_chord=True (K4''a),
// these are the fastest (PERF.md has the times): 2 lanes beat 4 and 8,
// which repeat the common sweep (gradient, solve, trial) on more lanes for
// each element, and 1, which builds the whole Hessian alone; at 218-221
// registers an SM holds 4 blocks (128 elements), and a cap to 168 registers
// (6 blocks) spills more than the warps it gains are worth. In double the
// same script (its chord64 family) times 2 and 4 lanes at 16 elements a
// block, at 255 registers and some 900 bytes of spills either way: 2 lanes
// (a block of one warp) are the faster there too, by 3-4 %.
template <typename R>
constexpr int kChordE = sizeof(R) == 4 ? 32 : 16;
constexpr int kChordGroup = 2;

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// NaN-propagating max (torch.maximum)
template <typename R>
__device__ __forceinline__ R maxnan(R a, R b) { return (a > b || a != a) ? a : b; }

template <typename R>
__device__ __forceinline__ R edet3(const R* z) {
  R E[9];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int j = 0; j < 3; ++j) E[d * 3 + j] = z[3 * (j + 1) + d] - z[d];
  return det33(E);
}

// H[tri(i, j) * S]: entry (i, j) of a lower triangle stored with stride S
#define HS(i, j) H[tri(i, j) * S]

// column j of the lower triangle of the Hessian at z (rows i >= j), from one
// dual pass; frj is free[j]
template <int S, typename C, typename R>
__device__ __forceinline__ void hess_col(int j, const R* z, const C& cells, const R* h,
                                         const R* dxpu, const R* fr, const Consts3<R>& k,
                                         R frj, R* H) {
  Dual<R> zd[12], gd[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) zd[i] = {z[i], i == j ? R(1) : R(0)};
  Dual<R> ihd;
  grad3<Dual<R>>(zd, cells, h, dxpu, fr, k, gd, ihd);
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    if (i < j) continue;
    R hv = gd[i].d * fr[i] * frj;
    if (i == j) hv = hv + (R(1) - fr[i]) + Num<R>::kLevenberg;
    HS(i, j) = hv;
  }
}

// H = L D L^T in place: D on the diagonal, L below it (ops/newton.py::ldlt_c)
template <int S, typename R>
__device__ __forceinline__ void factor12(R* H) {
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    R d = HS(j, j);
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - HS(j, k) * HS(j, k) * HS(k, k);
    d = abs_(d) < Num<R>::kDiagFloor ? Num<R>::kDiagFloor : d;
    HS(j, j) = d;
#pragma unroll
    for (int i = j + 1; i < 12; ++i) {
      R s = HS(i, j);
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - HS(i, k) * HS(j, k) * HS(k, k);
      HS(i, j) = s / d;
    }
  }
}

// the step p = -H^{-1} g from the factored H, or -g/w^2 where it is not finite
template <int S, typename R>
__device__ __forceinline__ void direction(const R* H, const R* g, R inv_w2, R* p) {
  R zv[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    R s = -g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - HS(i, k) * zv[k];
    zv[i] = s;
  }
#pragma unroll
  for (int i = 11; i >= 0; --i) {
    R s = zv[i] / HS(i, i);
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

// the trial point z + alpha p is accepted at a finite energy not above e0
// whose orientation determinant stays above det_floor
template <typename C, typename R>
__device__ __forceinline__ bool trial_ok(const R* z, const R* p, real_t<R> alpha,
                                         const C& cells, const R* h, const R* dxpu,
                                         const Consts3<R>& k, R e0, R det_floor) {
  R zt[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) zt[i] = z[i] + alpha * p[i];
  R e_t = energy3(zt, cells, h, dxpu, k);
  return isfinite(e_t) && e_t <= e0 && edet3(zt) > det_floor;
}

// the backtracking step sizes 1/16, 1/8, 1/4, 1/2, 1: 2^(a - 4), exact
template <typename R>
__device__ __forceinline__ R alpha_bt(int a) { return R(0.0625) * (R)(1 << a); }

// min(det0, 0), NaN kept (torch.clamp_max)
template <typename R>
__device__ __forceinline__ R floor_of(R det0) {
  return det0 < R(0) ? det0 : (det0 != det0 ? det0 : R(0));
}

// the gradient's 1-norm, in channel order
template <typename R>
__device__ __forceinline__ R norm1(const R* g) {
  R s = abs_(g[0]);
#pragma unroll
  for (int i = 1; i < 12; ++i) s = s + abs_(g[i]);
  return s;
}

// max |v_i|, NaN kept, in channel order
template <typename R>
__device__ __forceinline__ R absmax(const R* v) {
  R m = abs_(v[0]);
#pragma unroll
  for (int i = 1; i < 12; ++i) m = maxnan(m, abs_(v[i]));
  return m;
}

// ---- Newton sweeps (K4, K4''b): a group of kGroup lanes per element --------

// A block's staged inputs and its elements' Hessian triangles, for kE
// elements: the cells [channel][element] (see SharedCells), the rest
// [element][channel]. In float, 42.3 KB (K4, K4''a) and 43.4 KB (K4''b,
// K4') at kE = 32; in double, 42.2 KB and 43.4 KB at kE = 16.
template <typename R, bool kComp, int kE>
struct NewtonStage {
  R cells[kCells * kE];
  R z[kE * 12], dxpu[kE * 12], fr[kE * 12];
  R eh[kComp ? kE * 9 : 1];
  R hess[kE * kTri];
};

// backtracking over the group: trial a on lane a % G in round a / G; the
// largest accepted alpha, 0 if none (what the sequential loop of
// ops/newton.py::_backtrack returns)
template <int G, typename C, typename R>
__device__ __forceinline__ R backtrack_group(const R* z, const R* p, const C& cells, const R* h,
                                             const R* dxpu, const Consts3<R>& k, R e0,
                                             R det_floor, int lane, int base, unsigned gmask) {
  unsigned accepted = 0;  // bit a: trial a accepted
#pragma unroll 1
  for (int r = 0; r * G < 5; ++r) {
    const int a = r * G + lane;
    const bool ok = a < 5 && trial_ok(z, p, alpha_bt<R>(a), cells, h, dxpu, k, e0, det_floor);
    const unsigned votes = __ballot_sync(gmask, ok);
    accepted |= ((votes >> base) & ((1u << G) - 1u)) << (r * G);
  }
  return accepted ? alpha_bt<R>(31 - __clz(accepted)) : R(0);
}

// K4 (kComp false, the constant Ehat eh) and K4''b (kComp true, ehat_in):
// Newton sweeps in the JAX order, except that a sweep retires on its
// gradient before it builds the Hessian (see the note at the top).
template <typename R, bool kComp, int G>
__global__ void __launch_bounds__(kNewtonThreads<R>, kComp ? kBlocksComp : kBlocks) prox3d_newton_kernel(
    const R* __restrict__ z_in, const R* __restrict__ dxpu_in,
    const R* __restrict__ free_in, const R* __restrict__ cells_in,
    const R* __restrict__ ehat_in, R* __restrict__ zout, R* __restrict__ ih0_out,
    long long n, Ehat3<R> eh, Consts3<R> k, int max_iters) {
  static_assert(G == 4 || G == 8 || G == 16, "a group is 4, 8 or 16 lanes of one warp");
  constexpr int kT = kNewtonThreads<R>;
  constexpr int kE = kT / G;  // elements per block
  __shared__ __align__(16) NewtonStage<R, kComp, kE> st;
  const long long first = (long long)blockIdx.x * kE;
  stage_rows<kE, kT>(st.cells, cells_in, kCells, n, first);
  stage_cols<kE, kT>(st.z, z_in, 12, n, first);
  stage_cols<kE, kT>(st.dxpu, dxpu_in, 12, n, first);
  stage_cols<kE, kT>(st.fr, free_in, 12, n, first);
  if constexpr (kComp) stage_cols<kE, kT>(st.eh, ehat_in, 9, n, first);
  copies_done();
  __syncthreads();  // the block's only barrier: every lane below is in a live group

  const int el = threadIdx.x / G, lane = threadIdx.x % G;
  const long long e = first + el;
  if (e >= n) return;
  const int base = (threadIdx.x % 32) - lane;  // the group's first lane in its warp
  const unsigned gmask = ((1u << G) - 1u) << base;
  const SharedCells<R, kE> cells{st.cells + el};
  const R* dxpu = st.dxpu + el * 12;
  const R* fr = st.fr + el * 12;
  const R* h = kComp ? st.eh + el * 9 : eh.h;
  R* H = st.hess + el * kTri;
  R z[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) z[c] = st.z[el * 12 + c];

  if (lane == 0) ih0_out[e] = energy3_unreg(z, cells, h, k);
  for (int it = 0; it < max_iters; ++it) {
    // gradient, its norm and the regularized energy at the start
    R g[12];
    R ih;
    const R e0 = grad3<R>(z, cells, h, dxpu, fr, k, g, ih);
    // retire on a small gradient from the second sweep on, before moving
    // and before the Hessian, which such an element would not use
    if (it > 0 && norm1(g) < k.tol) break;

    // the Hessian's columns, spread over the group
#pragma unroll 1
    for (int j = lane; j < 12; j += G) hess_col<1>(j, z, cells, h, dxpu, fr, k, fr[j], H);
    __syncwarp(gmask);
    R L[kTri], p[12];
#pragma unroll
    for (int t = 0; t < kTri; ++t) L[t] = H[t];
    __syncwarp(gmask);  // every lane has its copy before the next sweep writes H
    factor12<1>(L);
    direction<1>(L, g, k.inv_w2, p);

    const R det_floor = floor_of(edet3(z));
    const R alpha =
        backtrack_group<G>(z, p, cells, h, dxpu, k, e0, det_floor, lane, base, gmask);
    const R step_inf = alpha * absmax(p);
    const bool stalled = step_inf <= Num<R>::kEpsStall * (R(1) + absmax(z));
#pragma unroll
    for (int i = 0; i < 12; ++i) z[i] = z[i] + alpha * p[i];
    if (stalled) break;
  }
#pragma unroll
  for (int c = 0; c < 12; ++c)
    if (c % G == lane) zout[c * n + e] = z[c];  // z stays in registers
}

// ---- chord sweeps (K4', K4''a): a group of kChordGroup lanes per element --

// direction<1> on the cached factors, out of line: inlined into the chord
// sweep, the sweep spills some 500 bytes at 255 registers (ptxas, the
// "solve inlined" variant of scripts/cuda_k4_variants.py); out of line, g
// and p pass through 96 bytes of stack and nothing spills
template <typename R>
__device__ __noinline__ void cached_direction(const R* H, const R* g, R inv_w2, R* p) {
  direction<1>(H, g, inv_w2, p);
}

// the element's Hessian at z into its cache H, factored: the columns spread
// over the group, then one lane factors in place (every lane factoring a copy
// in its registers, one writing it back, is no faster); every lane of the
// group has read the old cache before this is called
template <int G, typename C, typename R>
__device__ __forceinline__ void chord_refresh(const R* z, const C& cells, const R* h,
                                              const R* dxpu, const R* fr, const Consts3<R>& k,
                                              int lane, unsigned gmask, R* H) {
#pragma unroll 1
  for (int j = lane; j < 12; j += G) hess_col<1>(j, z, cells, h, dxpu, fr, k, fr[j], H);
  __syncwarp(gmask);
  if (lane == 0) factor12<1>(H);
  __syncwarp(gmask);  // the factored cache is the group's
}

// K4' (kComp true, ehat_in) and K4''a (kComp false, the constant eh). Each
// sweep keeps make_chord_sweeps' order, except that it retires on its
// gradient before it solves.
//
// The refresh: the JAX kernel guards it per tile (pl.when over the tile's
// max of active & ~ok1) and writes the new Hessian and step only where the
// cached step was rejected (h_write(H2, keep=ok1), where(ok1, p, alpha
// p2)). Here the guard is per element, and gives the same results: an
// element that accepts the cached step keeps its cached Hessian and that
// step whether or not a neighbour refreshes, and an element the JAX kernel
// refreshes without needing it is one that is no longer active, which never
// moves again. An element that retires on its gradient norm does not move
// either, so it leaves before the solve.
template <typename R, bool kComp, int G>
__global__ void __launch_bounds__(kChordE<R> * G)
    prox3d_chord_kernel(const R* __restrict__ z_in, const R* __restrict__ dxpu_in,
                        const R* __restrict__ free_in, const R* __restrict__ cells_in,
                        const R* __restrict__ ehat_in, R* __restrict__ zout,
                        R* __restrict__ ih0_out, long long n, Ehat3<R> eh, Consts3<R> k,
                        int max_iters) {
  static_assert(G == 2 || G == 4 || G == 8, "a group is 2, 4 or 8 lanes of one warp");
  constexpr int kE = kChordE<R>;  // elements per block
  constexpr int kT = kE * G;       // threads per block
  __shared__ __align__(16) NewtonStage<R, kComp, kE> st;
  const long long first = (long long)blockIdx.x * kE;
  stage_rows<kE, kT>(st.cells, cells_in, kCells, n, first);
  stage_cols<kE, kT>(st.z, z_in, 12, n, first);
  stage_cols<kE, kT>(st.dxpu, dxpu_in, 12, n, first);
  stage_cols<kE, kT>(st.fr, free_in, 12, n, first);
  if constexpr (kComp) stage_cols<kE, kT>(st.eh, ehat_in, 9, n, first);
  copies_done();
  __syncthreads();  // the block's only barrier: every lane below is in a live group

  const int el = threadIdx.x / G, lane = threadIdx.x % G;
  const long long e = first + el;
  if (e >= n) return;
  const int base = (threadIdx.x % 32) - lane;  // the group's first lane in its warp
  const unsigned gmask = ((1u << G) - 1u) << base;
  const SharedCells<R, kE> cells{st.cells + el};
  const R* dxpu = st.dxpu + el * 12;
  const R* fr = st.fr + el * 12;
  const R* h = kComp ? st.eh + el * 9 : eh.h;
  R* H = st.hess + el * kTri;  // the chord cache, factored
  R z[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) z[c] = st.z[el * 12 + c];

  if (max_iters <= 0 && lane == 0) ih0_out[e] = energy3_unreg(z, cells, h, k);
  for (int it = 0; it < max_iters; ++it) {
    // gradient, its norm and the regularized energy at the start
    R g[12];
    R ih;
    const R e0 = grad3<R>(z, cells, h, dxpu, fr, k, g, ih);
    if (it == 0 && lane == 0) ih0_out[e] = ih;  // the unregularized energy at the input
    // retire on a small gradient from the second sweep on, before moving
    if (it > 0 && norm1(g) < k.tol) break;
    const R det_floor = floor_of(edet3(z));

    // from the second sweep on, the cached factors' step, tried once at alpha 1
    R p[12];
    bool ok = false;
    if (it > 0) {
      cached_direction(H, g, k.inv_w2, p);
      ok = trial_ok(z, p, R(1), cells, h, dxpu, k, e0, det_floor);
    }
    if (!ok) {
      // the Hessian at z into the cache: the entry Hessian in the first
      // sweep, whose step is then the cached step tried at alpha 1 (were it
      // rejected, the refresh would build the same Hessian at the same z),
      // else a refresh; then backtracking where the step is rejected
      __syncwarp(gmask);  // every lane has solved with the old cache, if any
      chord_refresh<G>(z, cells, h, dxpu, fr, k, lane, gmask, H);
      cached_direction(H, g, k.inv_w2, p);
      ok = it == 0 && trial_ok(z, p, R(1), cells, h, dxpu, k, e0, det_floor);
      if (!ok) {
        const R alpha =
            backtrack_group<G>(z, p, cells, h, dxpu, k, e0, det_floor, lane, base, gmask);
#pragma unroll
        for (int i = 0; i < 12; ++i) p[i] = alpha * p[i];
      }
    }
    const bool stalled = absmax(p) <= Num<R>::kEpsStall * (R(1) + absmax(z));
#pragma unroll
    for (int i = 0; i < 12; ++i) z[i] = z[i] + p[i];
    if (stalled) break;
  }
#pragma unroll
  for (int c = 0; c < 12; ++c)
    if (c % G == lane) zout[c * n + e] = z[c];  // z stays in registers
}

template <typename R, bool kChord, bool kComp>
int launch(const R* z, const R* dxpu, const R* free_, const R* cells, const R* ehat, R* zout,
           R* ih0, long long n, const R* consts, int max_iters, void* stream) {
  if (n <= 0) return 0;
  Ehat3<R> eh{};
  Consts3<R> k;
  if constexpr (!kComp) std::memcpy(&eh, consts, sizeof(eh));
  std::memcpy(&k, consts + (kComp ? 0 : 9), sizeof(k));
  if constexpr (kChord) {
    constexpr int kE = kChordE<R>;
    const long long blocks = (n + kE - 1) / kE;
    prox3d_chord_kernel<R, kComp, kChordGroup>
        <<<(unsigned)blocks, kE * kChordGroup, 0, (cudaStream_t)stream>>>(
            z, dxpu, free_, cells, ehat, zout, ih0, n, eh, k, max_iters);
  } else {
    constexpr int kT = kNewtonThreads<R>, kE = kT / kGroup;
    const long long blocks = (n + kE - 1) / kE;
    prox3d_newton_kernel<R, kComp, kGroup><<<(unsigned)blocks, kT, 0, (cudaStream_t)stream>>>(
        z, dxpu, free_, cells, ehat, zout, ih0, n, eh, k, max_iters);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// consts: K4 and K4''a take 18 values, Ehat row-major, then the 9 of
// Consts3 (w^2, w^2/2, 1/w^2, tol, then the five constants of
// ops/prox3d.py), all in the kernel's real type; K4' and K4''b take the 9
// of Consts3 and ehat [9, n], each element's own Ehat.
extern "C" int mm_prox3d(const float* z, const float* dxpu, const float* free_,
                         const float* cells, float* zout, float* ih0, long long n,
                         const float* consts, int max_iters, void* stream) {
  return launch<float, false, false>(z, dxpu, free_, cells, nullptr, zout, ih0, n, consts,
                                     max_iters, stream);
}

extern "C" int mm_prox3d_f64(const double* z, const double* dxpu, const double* free_,
                             const double* cells, double* zout, double* ih0, long long n,
                             const double* consts, int max_iters, void* stream) {
  return launch<double, false, false>(z, dxpu, free_, cells, nullptr, zout, ih0, n, consts,
                                      max_iters, stream);
}

extern "C" int mm_prox3d_chord_comp(const float* z, const float* dxpu, const float* free_,
                                    const float* cells, const float* ehat, float* zout,
                                    float* ih0, long long n, const float* consts, int max_iters,
                                    void* stream) {
  return launch<float, true, true>(z, dxpu, free_, cells, ehat, zout, ih0, n, consts,
                                   max_iters, stream);
}

extern "C" int mm_prox3d_chord(const float* z, const float* dxpu, const float* free_,
                               const float* cells, float* zout, float* ih0, long long n,
                               const float* consts, int max_iters, void* stream) {
  return launch<float, true, false>(z, dxpu, free_, cells, nullptr, zout, ih0, n, consts,
                                    max_iters, stream);
}

extern "C" int mm_prox3d_comp(const float* z, const float* dxpu, const float* free_,
                              const float* cells, const float* ehat, float* zout, float* ih0,
                              long long n, const float* consts, int max_iters, void* stream) {
  return launch<float, false, true>(z, dxpu, free_, cells, ehat, zout, ih0, n, consts,
                                    max_iters, stream);
}

extern "C" int mm_prox3d_chord_comp_f64(const double* z, const double* dxpu, const double* free_,
                                        const double* cells, const double* ehat, double* zout,
                                        double* ih0, long long n, const double* consts,
                                        int max_iters, void* stream) {
  return launch<double, true, true>(z, dxpu, free_, cells, ehat, zout, ih0, n, consts,
                                    max_iters, stream);
}

extern "C" int mm_prox3d_chord_f64(const double* z, const double* dxpu, const double* free_,
                                   const double* cells, double* zout, double* ih0, long long n,
                                   const double* consts, int max_iters, void* stream) {
  return launch<double, true, false>(z, dxpu, free_, cells, nullptr, zout, ih0, n, consts,
                                     max_iters, stream);
}

extern "C" int mm_prox3d_comp_f64(const double* z, const double* dxpu, const double* free_,
                                  const double* cells, const double* ehat, double* zout,
                                  double* ih0, long long n, const double* consts, int max_iters,
                                  void* stream) {
  return launch<double, false, true>(z, dxpu, free_, cells, ehat, zout, ih0, n, consts,
                                     max_iters, stream);
}
