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
// lanes per element, with the element's whole sweep state on the
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
//     l of G taking the columns l, l + G, ..., each written to the
//     element's 78-entry triangle in shared memory; each column's pass is
//     the one-thread design's pass, so its bits do not change;
//   - every lane then factors and solves that triangle in its registers,
//     in the one order of factor12 and direction, so every lane holds the
//     same step p (on a SIMT warp, redundant work costs the group what one
//     lane doing it alone would, and needs no broadcast); or, in the double
//     builds of K4 and K4''b, the group factors it in place, each lane a
//     share of each column's rows (factor12_group), and every lane solves
//     with the factored triangle (cached_direction, or inlined);
//   - the five backtracking trials are spread over the lanes, and a ballot
//     of the group gives the largest accepted alpha, which is what the
//     sequential loop returns;
//   - the gradient, the retire and stall tests and the fallback are
//     computed by every lane from the same data, so every lane of a group
//     takes the same branch (K4''b's double build shares the monitor
//     samples of the gradient and of the trial at alpha 1, which it makes
//     first, out over the group: GroupCells); a group
//     synchronizes on its own mask (__syncwarp, __ballot_sync,
//     __shfl_sync), and a block only once, after staging.
// Each build's layout (threads, lanes, blocks an SM, where the stage and
// the factor live) is chosen by timing (scripts/cuda_k4_variants.py, which
// times layouts against the one-thread-per-element design and against the
// earlier layouts): see Layout and the builds below.
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
//     in the Newton kernels, then one lane factors the triangle in place
//     (K4' and K4''a in double: the group, factor12_group);
//   - a common sweep is the gradient, the retire test (from the second
//     sweep on), the solve with the cached factors (out of line, see
//     cached_direction) and one trial at alpha 1, all computed by every
//     lane from the same data, so every lane takes the same branch; in
//     K4''a's double build the gradient and the trial share their monitor
//     samples out over the group (GroupCells), the rest stays on every
//     lane, and the solve is inlined;
//   - only a rejected trial refreshes: the columns again over the group
//     into the cache, the factor, the solve and the five trials over the
//     group (the ballot of backtrack_group);
//   - the element's first gradient also gives ih0: it is the same float
//     operations as the energy at the input.
// A refresh is guarded per element: a group that keeps its cached step skips
// it (though its lanes idle while another group of its warp refreshes). The
// layouts are chosen by timing, as the Newton kernels' are.

#include <cstring>
#include <type_traits>

#include "huang3d.cuh"
#include "stage.cuh"

namespace {

static_assert(sizeof(Consts3<float>) == 9 * sizeof(float), "Consts3 is 9 packed values");
static_assert(sizeof(Consts3<double>) == 9 * sizeof(double), "Consts3 is 9 packed values");

constexpr int kTri = 78;       // entries of the lower triangle of a 12x12 matrix
constexpr int kCells = 216;    // cell channels per element

// Who factors an element's Hessian triangle: every lane a copy in its
// registers (factor12 on L, then direction on L), one lane in place in
// shared memory while the others wait, or the group in place, the rows of
// each column spread over its lanes (factor12_group). All three perform each
// entry's operations in factor12's order.
constexpr int kEveryLane = 0, kOneLane = 1, kSpread = 2;

// A build's layout: kThreads threads a block, kGroup lanes an element (kE =
// kThreads / kGroup elements a block), at least kMinBlocks blocks an SM at
// once (__launch_bounds__: the registers capped at 65,536 / (kThreads x
// kMinBlocks), and at 255), and the factor as above. With kShare, the
// evaluations that every lane of a group makes at the same point (a sweep's
// gradient, the energy at the input, the chord sweep's trial at alpha 1, the
// Newton sweep's trial at alpha 1, made first) share their four monitor
// samples out over the group (GroupCells), and the solve with the factored
// triangle is inlined into the sweep (else out of line, cached_direction).
// A block's stage (NewtonStage) is static shared memory, at most 48 KB a
// block.
template <int T, int G, int B, int kFactorBy, bool kShareSamples = false>
struct Layout {
  static constexpr int kThreads = T, kGroup = G, kE = T / G, kMinBlocks = B;
  static constexpr int kFactor = kFactorBy;
  static constexpr bool kShare = kShareSamples;
};

// The Newton sweeps in float (K4, K4''b): 4 lanes an element, 32 elements a
// block staged in shared memory (NewtonStage: 330 values an element, 42.3
// KB), at least 4 (K4) and 3 (K4''b) blocks an SM, so at most 128 and 168
// registers; every lane factors a copy of the triangle. Of the variants
// that scripts/cuda_k4_variants.py times on the H100 at the step-0 inputs
// of 3D Shoulder-40 (K4) and CompSquare-40 (K4''b), these are the fastest
// (PERF.md has the times): 4 lanes beat 8 and 16, whose lanes idle longer in
// the gradient, factor and solve (and 16 spill); with no cap both take
// 220-222 registers and 2 blocks an SM, and the cap's few hundred bytes of
// spills cost less than the warps it adds.
//
// The chord sweeps in float (K4', K4''a): 2 lanes an element, 32 elements a
// block with the same staging (the chord cache in the triangle's place),
// one lane factoring, no register cap: 2 lanes beat 4 and 8, which repeat
// the common sweep (gradient, solve, trial) on more lanes for each element,
// and 1, which builds the whole Hessian alone; at 218-221 registers an SM
// holds 4 blocks (128 elements), and a cap to 168 registers (6 blocks)
// spills more than the warps it gains are worth.
//
// The double builds have layouts of their own (K4Double, K4ChordCompDouble,
// K4CompDouble, K4ChordDouble below), chosen by timing on the H100.
template <bool kComp>
using NewtonFloat = Layout<128, 4, kComp ? 3 : 4, kEveryLane>;
using ChordFloat = Layout<64, 2, 1, kOneLane>;
template <typename R, bool kChord, bool kComp>
struct Build {
  using L = std::conditional_t<kChord, ChordFloat, NewtonFloat<kComp>>;
};

// K4 in double: 4 lanes an element, 16 elements a block of 64 (the float
// stage cut to 42.2 KB of static shared memory), the triangle factored in
// place with its rows spread over the group, at least 4 blocks an SM: 255
// registers, so an SM holds 4 blocks (8 warps, 64 elements), with 900/1,668
// bytes of spills (996/1,876 with every lane factoring a copy, as K4''b
// does: a lane keeps no 78-entry copy). Of the layouts that
// scripts/cuda_k4_variants.py newton64 times on the H100 at the step-0
// inputs of 3D Shoulder-40 and SquareGrid-40 in float64 (PERF.md has the
// times), the fastest at both of those that leave the other builds' static
// stages as they are, and faster there than K4''b's layout: the spread
// factor takes 66 divisions a Hessian from every lane to 21 rounds over the
// group. A stage of 32 or 64 elements in dynamic shared memory is faster
// still at Shoulder-40 (13.5 and 12.0 ms against 14.6), but a kernel with a
// dynamic stage in this source pads every other build's static stage to 16
// bytes (ptxas). Reading the cells from device memory instead (912 bytes an
// element staged) lets 12-16 warps reside but spills 2.6-5.2 KB a lane and
// runs 2.7-3.5x slower; a register cap (5 blocks of 64, 168 registers)
// spills 2 KB and loses 18-45 %.
using K4Double = Layout<64, 4, 4, kSpread>;
template <>
struct Build<double, false, false> {
  using L = K4Double;
};

// K4' in double: 4 lanes an element, 16 elements a block of 64 (the stage
// of 43.4 KB in static shared memory), the chord cache factored with its
// rows spread over the group, no register cap: at 255 registers an SM holds
// 4 blocks (8 warps, 64 elements), where 2 lanes in a block of one warp with
// one lane factoring (K4''a's layout) hold 5 by shared memory (5 warps, 80
// elements). Of the layouts that scripts/cuda_k4_variants.py chord64
// times on the H100 at the step-0 inputs of 3D CompSquare-40 and -20 in
// float64, the fastest beside K4''a's layout at both (2 lanes with the
// spread factor within 1-2 % at CompSquare-40, 7 % slower at -20); the
// cells from device memory run 2-2.5x slower, as for K4.
using K4ChordCompDouble = Layout<64, 4, 1, kSpread>;
template <>
struct Build<double, true, true> {
  using L = K4ChordCompDouble;
};

// K4''b and K4''a in double: K4's and K4''s plans (4 lanes an element, 16
// elements a block of 64 staged, the triangle factored in place with its
// rows spread over the group: 255 registers, 8 warps an SM), and the
// evaluations that every lane of a group makes at the same point (the
// sweep's gradient, the energy at the input, the chord sweep's trial at
// alpha 1) share their four monitor samples out over the group (kShare: a
// lane samples one vertex and the group broadcasts the samples), the solve
// is inlined, and K4''b tries alpha 1 first. Of the layouts that
// scripts/cuda_k4_variants.py comp64 and chord_box64 time on the H100 at
// the step-0 inputs of 3D CompSquare-40 and -20 (K4''b) and SquareGrid-40
// and -20 (K4''a) in float64 and at the first prox call of step 5 at -40,
// these are the fastest at all three (PERF.md has the times): 14-32 %
// faster than the earlier layouts (K4''b every lane factoring a copy,
// K4''a 2 lanes in a block of one warp with one lane factoring, 5 warps an
// SM), of which the plans of K4 and K4' alone give 4-8 %. Two or three
// Hessian columns a dual pass (DualN) spill 2.4-5.1 KB a lane and lose
// 20-60 %; the solve spread over the group does not gain; a stage of 32
// or 64 elements in dynamic shared memory is within 2 %, which would not
// pay for a translation unit of its own (in this source it pads the other
// builds' static stages).
using K4CompDouble = Layout<64, 4, 4, kSpread, true>;
using K4ChordDouble = Layout<64, 4, 1, kSpread, true>;
template <>
struct Build<double, false, true> {  // K4''b
  using L = K4CompDouble;
};
template <>
struct Build<double, true, false> {  // K4''a
  using L = K4ChordDouble;
};

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

// factor12<1> by the G lanes of a group (mask gmask) on the triangle H in
// shared memory: column by column, every lane computes the column's
// diagonal (keeping D in registers), lane l the rows j + 1 + l, j + 1 + l +
// G, ...; each entry's operations in factor12's order. Returns once the
// factored triangle is the group's.
template <int G, typename R>
__device__ __forceinline__ void factor12_group(R* H, int lane, unsigned gmask) {
  R D[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    R d = H[tri(j, j)];
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - H[tri(j, k)] * H[tri(j, k)] * D[k];
    d = abs_(d) < Num<R>::kDiagFloor ? Num<R>::kDiagFloor : d;
    D[j] = d;
#pragma unroll
    for (int r = 0; r < (11 - j + G - 1) / G; ++r) {
      const int i = j + 1 + lane + r * G;
      if (i < 12) {
        R* Hi = H + tri(i, 0);
        R s = Hi[j];
#pragma unroll
        for (int k = 0; k < j; ++k) s = s - Hi[k] * H[tri(j, k)] * D[k];
        Hi[j] = s / d;
      }
    }
    __syncwarp(gmask);  // column j is the group's; every lane has read H(j, j)
    if (lane == 0) H[tri(j, j)] = d;
  }
  __syncwarp(gmask);
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

// One element's cells as the G lanes of its group read them where all of
// them evaluate at the same point: huang3d.cuh's sample4 for this accessor
// samples vertex v on lane v % G only (sample_m3's operations, so the same
// bits) and broadcasts each sample within the group's mask, so a lane
// samples 4 / G vertices, not 4.
template <class C, int G>
struct GroupCells {
  C cells;
  int lane, base;  // the lane in its group, the group's first lane in its warp
  unsigned gmask;
  __device__ __forceinline__ auto operator()(int c) const { return cells(c); }
};

template <class C, int G, typename R>
__device__ __forceinline__ void sample4(const GroupCells<C, G>& c, const R* z, R (*m)[6]) {
  static_assert(4 % G == 0, "a group of 1, 2 or 4 lanes shares the four samples");
  R mine[4 / G][6];
#pragma unroll
  for (int r = 0; r < 4 / G; ++r) {
    const int v = c.lane + r * G;
    R x = z[0], y = z[1], w = z[2];  // vertex v's point, by selects (z stays in registers)
#pragma unroll
    for (int u = 1; u < 4; ++u)
      if (v == u) {
        x = z[3 * u];
        y = z[3 * u + 1];
        w = z[3 * u + 2];
      }
    sample_m3(c.cells, v, x, y, w, mine[r]);
  }
#pragma unroll
  for (int v = 0; v < 4; ++v)
#pragma unroll
    for (int e = 0; e < 6; ++e) m[v][e] = __shfl_sync(c.gmask, mine[v / G][e], c.base + v % G);
}

// the accessor of the evaluations that every lane of a group makes at the
// same point: GroupCells where the layout D shares their samples out, else
// the element's cells as they are
template <class D, class C>
__device__ __forceinline__ auto common_cells(const C& cells, int lane, int base, unsigned gmask) {
  if constexpr (D::kShare)
    return GroupCells<C, D::kGroup>{cells, lane, base, gmask};
  else
    return cells;
}

// ---- Newton sweeps (K4, K4''b): a group of lanes per element -------------

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

// the block's inputs into its stage, then the block's only barrier
template <class D, bool kComp, typename R, typename S>
__device__ __forceinline__ void stage_block(S& st, const R* z_in, const R* dxpu_in,
                                            const R* free_in, const R* cells_in,
                                            const R* ehat_in, long long n, long long first) {
  constexpr int kE = D::kE, kT = D::kThreads;
  stage_rows<kE, kT>(st.cells, cells_in, kCells, n, first);
  stage_cols<kE, kT>(st.z, z_in, 12, n, first);
  stage_cols<kE, kT>(st.dxpu, dxpu_in, 12, n, first);
  stage_cols<kE, kT>(st.fr, free_in, 12, n, first);
  if constexpr (kComp) stage_cols<kE, kT>(st.eh, ehat_in, 9, n, first);
  copies_done();
  __syncthreads();  // the block's only barrier: every lane below is in a live group
}

// direction<1> on a factored triangle in shared memory, out of line:
// inlined into a sweep, the sweep spills some 500 bytes at 255 registers
// (ptxas, the "solve inlined" variant of scripts/cuda_k4_variants.py); out
// of line, g and p pass through 96 bytes of stack and nothing spills
template <typename R>
__device__ __noinline__ void cached_direction(const R* H, const R* g, R inv_w2, R* p) {
  direction<1>(H, g, inv_w2, p);
}

// the step from the factored triangle H in shared memory: inlined where the
// layout D shares samples out (out of line, K4''b runs as fast and K4''a
// slower), else out of line
template <class D, typename R>
__device__ __forceinline__ void solve(const R* H, const R* g, R inv_w2, R* p) {
  if constexpr (D::kShare)
    direction<1>(H, g, inv_w2, p);
  else
    cached_direction(H, g, inv_w2, p);
}

// the triangle H in shared memory, whose columns the group has written,
// factored in place as the layout D factors (kOneLane or kSpread); returns
// once the factored triangle is the group's
template <class D, typename R>
__device__ __forceinline__ void factor_in_place(R* H, int lane, unsigned gmask) {
  if constexpr (D::kFactor == kSpread) {
    factor12_group<D::kGroup>(H, lane, gmask);
  } else {
    if (lane == 0) factor12<1>(H);
    __syncwarp(gmask);
  }
}

// backtracking over the group: trial a on lane a % G in round a / G; the
// largest accepted alpha, 0 if none (what the sequential loop of
// ops/newton.py::_backtrack returns). With kFullFirst, the largest step (a
// = 4, alpha 1) is tried first, on every lane with the samples of the
// layout D's common evaluations (ccells): accepted, it is the answer, and
// the rounds take the other four only where it is not.
template <class D, bool kFullFirst, typename C, typename CC, typename R>
__device__ __forceinline__ R backtrack_group(const R* z, const R* p, const C& cells,
                                             const CC& ccells, const R* h, const R* dxpu,
                                             const Consts3<R>& k, R e0, R det_floor, int lane,
                                             int base, unsigned gmask) {
  constexpr int G = D::kGroup;
  if constexpr (kFullFirst) {
    if (trial_ok(z, p, alpha_bt<R>(4), ccells, h, dxpu, k, e0, det_floor)) return alpha_bt<R>(4);
  }
  constexpr int kRounds = kFullFirst ? 4 : 5;  // the trials left to the rounds
  unsigned accepted = 0;  // bit a: trial a accepted
#pragma unroll 1
  for (int r = 0; r * G < kRounds; ++r) {
    const int a = r * G + lane;
    const bool ok =
        a < kRounds && trial_ok(z, p, alpha_bt<R>(a), cells, h, dxpu, k, e0, det_floor);
    const unsigned votes = __ballot_sync(gmask, ok);
    accepted |= ((votes >> base) & ((1u << G) - 1u)) << (r * G);
  }
  return accepted ? alpha_bt<R>(31 - __clz(accepted)) : R(0);
}

// K4 (kComp false, the constant Ehat eh) and K4''b (kComp true, ehat_in):
// Newton sweeps in the JAX order, except that a sweep retires on its
// gradient before it builds the Hessian (see the note at the top); laid out
// as D says.
template <typename R, bool kComp, class D>
__global__ void __launch_bounds__(D::kThreads, D::kMinBlocks) prox3d_newton_kernel(
    const R* __restrict__ z_in, const R* __restrict__ dxpu_in,
    const R* __restrict__ free_in, const R* __restrict__ cells_in,
    const R* __restrict__ ehat_in, R* __restrict__ zout, R* __restrict__ ih0_out,
    long long n, Ehat3<R> eh, Consts3<R> k, int max_iters) {
  constexpr int G = D::kGroup, kE = D::kE;
  static_assert(G == 2 || G == 4 || G == 8 || G == 16, "a group is 2-16 lanes of one warp");
  __shared__ __align__(16) NewtonStage<R, kComp, kE> st;
  const long long first = (long long)blockIdx.x * kE;
  stage_block<D, kComp>(st, z_in, dxpu_in, free_in, cells_in, ehat_in, n, first);

  const int el = threadIdx.x / G, lane = threadIdx.x % G;
  const long long e = first + el;
  if (e >= n) return;
  const int base = (threadIdx.x % 32) - lane;  // the group's first lane in its warp
  const unsigned gmask = ((1u << G) - 1u) << base;
  const SharedCells<R, kE> cells{st.cells + el};
  const auto ccells = common_cells<D>(cells, lane, base, gmask);  // the group's common evaluations
  const R* dxpu = st.dxpu + el * 12;
  const R* fr = st.fr + el * 12;
  const R* h = kComp ? st.eh + el * 9 : eh.h;
  R* H = st.hess + el * kTri;
  R z[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) z[c] = st.z[el * 12 + c];

  if constexpr (D::kShare) {
    const R ih0 = energy3_unreg(z, ccells, h, k);  // on every lane, its samples shared out
    if (lane == 0) ih0_out[e] = ih0;
  } else {
    if (lane == 0) ih0_out[e] = energy3_unreg(z, cells, h, k);
  }
  for (int it = 0; it < max_iters; ++it) {
    // gradient, its norm and the regularized energy at the start
    R g[12];
    R ih;
    const R e0 = grad3<R>(z, ccells, h, dxpu, fr, k, g, ih);
    // retire on a small gradient from the second sweep on, before moving
    // and before the Hessian, which such an element would not use
    if (it > 0 && norm1(g) < k.tol) break;

    R p[12];
    if constexpr (D::kFactor == kEveryLane) {
      // the Hessian's columns, spread over the group
#pragma unroll 1
      for (int j = lane; j < 12; j += G) hess_col<1>(j, z, cells, h, dxpu, fr, k, fr[j], H);
      __syncwarp(gmask);
      R L[kTri];
#pragma unroll
      for (int t = 0; t < kTri; ++t) L[t] = H[t];
      __syncwarp(gmask);  // every lane has its copy before the next sweep writes H
      factor12<1>(L);
      direction<1>(L, g, k.inv_w2, p);
    } else {
      __syncwarp(gmask);  // every lane has solved with the last sweep's factors
#pragma unroll 1
      for (int j = lane; j < 12; j += G) hess_col<1>(j, z, cells, h, dxpu, fr, k, fr[j], H);
      __syncwarp(gmask);
      factor_in_place<D>(H, lane, gmask);
      solve<D>(H, g, k.inv_w2, p);
    }

    const R det_floor = floor_of(edet3(z));
    // where the samples are shared out, alpha 1 first: a Newton step near
    // convergence is taken whole, and the rounds are then not needed
    const R alpha = backtrack_group<D, D::kShare>(z, p, cells, ccells, h, dxpu, k, e0, det_floor,
                                                  lane, base, gmask);
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

// ---- chord sweeps (K4', K4''a): a group of lanes per element --------------

// the element's Hessian at z into its cache H, factored: the columns spread
// over the group, then the factor as D says; every lane of the group has
// read the old cache before this is called
template <class D, typename C, typename R>
__device__ __forceinline__ void chord_refresh(const R* z, const C& cells, const R* h,
                                              const R* dxpu, const R* fr, const Consts3<R>& k,
                                              int lane, unsigned gmask, R* H) {
#pragma unroll 1
  for (int j = lane; j < 12; j += D::kGroup) hess_col<1>(j, z, cells, h, dxpu, fr, k, fr[j], H);
  __syncwarp(gmask);
  factor_in_place<D>(H, lane, gmask);  // the factored cache is the group's
}

// K4' (kComp true, ehat_in) and K4''a (kComp false, the constant eh), laid
// out as D says. Each sweep keeps make_chord_sweeps' order, except that it
// retires on its gradient before it solves.
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
template <typename R, bool kComp, class D>
__global__ void __launch_bounds__(D::kThreads, D::kMinBlocks)
    prox3d_chord_kernel(const R* __restrict__ z_in, const R* __restrict__ dxpu_in,
                        const R* __restrict__ free_in, const R* __restrict__ cells_in,
                        const R* __restrict__ ehat_in, R* __restrict__ zout,
                        R* __restrict__ ih0_out, long long n, Ehat3<R> eh, Consts3<R> k,
                        int max_iters) {
  constexpr int G = D::kGroup, kE = D::kE;
  static_assert(G == 2 || G == 4 || G == 8, "a group is 2, 4 or 8 lanes of one warp");
  static_assert(D::kFactor != kEveryLane, "the chord cache is factored in place");
  __shared__ __align__(16) NewtonStage<R, kComp, kE> st;
  const long long first = (long long)blockIdx.x * kE;
  stage_block<D, kComp>(st, z_in, dxpu_in, free_in, cells_in, ehat_in, n, first);

  const int el = threadIdx.x / G, lane = threadIdx.x % G;
  const long long e = first + el;
  if (e >= n) return;
  const int base = (threadIdx.x % 32) - lane;  // the group's first lane in its warp
  const unsigned gmask = ((1u << G) - 1u) << base;
  const SharedCells<R, kE> cells{st.cells + el};
  const auto ccells = common_cells<D>(cells, lane, base, gmask);  // the group's common evaluations
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
    const R e0 = grad3<R>(z, ccells, h, dxpu, fr, k, g, ih);
    if (it == 0 && lane == 0) ih0_out[e] = ih;  // the unregularized energy at the input
    // retire on a small gradient from the second sweep on, before moving
    if (it > 0 && norm1(g) < k.tol) break;
    const R det_floor = floor_of(edet3(z));

    // from the second sweep on, the cached factors' step, tried once at alpha 1
    R p[12];
    bool ok = false;
    if (it > 0) {
      solve<D>(H, g, k.inv_w2, p);
      ok = trial_ok(z, p, R(1), ccells, h, dxpu, k, e0, det_floor);
    }
    if (!ok) {
      // the Hessian at z into the cache: the entry Hessian in the first
      // sweep, whose step is then the cached step tried at alpha 1 (were it
      // rejected, the refresh would build the same Hessian at the same z),
      // else a refresh; then backtracking where the step is rejected
      __syncwarp(gmask);  // every lane has solved with the old cache, if any
      chord_refresh<D>(z, cells, h, dxpu, fr, k, lane, gmask, H);
      solve<D>(H, g, k.inv_w2, p);
      ok = it == 0 && trial_ok(z, p, R(1), ccells, h, dxpu, k, e0, det_floor);
      if (!ok) {
        const R alpha = backtrack_group<D, false>(z, p, cells, ccells, h, dxpu, k, e0,
                                                  det_floor, lane, base, gmask);
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

// the kernel of a build
template <typename R, bool kChord, bool kComp>
auto kernel_of() {
  using D = typename Build<R, kChord, kComp>::L;
  if constexpr (kChord)
    return prox3d_chord_kernel<R, kComp, D>;
  else
    return prox3d_newton_kernel<R, kComp, D>;
}

template <typename R, bool kChord, bool kComp>
int launch(const R* z, const R* dxpu, const R* free_, const R* cells, const R* ehat, R* zout,
           R* ih0, long long n, const R* consts, int max_iters, void* stream) {
  if (n <= 0) return 0;
  Ehat3<R> eh{};
  Consts3<R> k;
  if constexpr (!kComp) std::memcpy(&eh, consts, sizeof(eh));
  std::memcpy(&k, consts + (kComp ? 0 : 9), sizeof(k));
  using D = typename Build<R, kChord, kComp>::L;
  const long long blocks = (n + D::kE - 1) / D::kE;
  const auto kernel = kernel_of<R, kChord, kComp>();
  kernel<<<(unsigned)blocks, D::kThreads, 0, (cudaStream_t)stream>>>(z, dxpu, free_, cells, ehat,
                                                                     zout, ih0, n, eh, k,
                                                                     max_iters);
  return (int)cudaGetLastError();
}

// a build's layout as the host sees it: out[0] the blocks an SM holds at
// once (the CUDA occupancy calculator), out[1] its threads a block, out[2]
// its lanes an element
template <typename R, bool kChord, bool kComp>
int layout_of(int* out) {
  using D = typename Build<R, kChord, kComp>::L;
  out[1] = D::kThreads;
  out[2] = D::kGroup;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel_of<R, kChord, kComp>(),
                                                            D::kThreads, 0);
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

// the layout of the build (chord, comp, f64) into out[3]: the blocks an SM
// holds at once, the threads a block, the lanes an element; returns the
// CUDA error
extern "C" int mm_prox3d_layout(int chord, int comp, int f64, int* out) {
  switch (chord * 4 + comp * 2 + f64) {
    case 0: return layout_of<float, false, false>(out);
    case 1: return layout_of<double, false, false>(out);
    case 2: return layout_of<float, false, true>(out);
    case 3: return layout_of<double, false, true>(out);
    case 4: return layout_of<float, true, false>(out);
    case 5: return layout_of<double, true, false>(out);
    case 6: return layout_of<float, true, true>(out);
    case 7: return layout_of<double, true, true>(out);
  }
  return (int)cudaErrorInvalidValue;
}
