"""Kernel K1 (``csrc/prox2d.cu``) against the one-thread-per-element
design it replaced and against variants of its group design, timed on the
card.

    python3 scripts/cuda_k1_variants.py

Builds, by plain ``nvcc`` into the git-ignored
``mmadmm_tpu_torch/_build/k1_variants/``, copies of ``csrc/``, all started
together (it prints how many):

- ``shipped``: ``prox2d.cu`` as it is, one thread an element;
- ``one thread per element``: ``prox2d.cu`` with the earlier K1 added
  (``prox2d_thread_kernel<R>``, ``THREAD_KERNEL`` below: the kernel and
  launch of the one-thread design as they stood before the staged design,
  on today's ``huang2d.cuh``, whose arithmetic is theirs), each thread
  sweeping its element alone with its 48 cell channels, z, dxpu, free, the
  triangle and the factor in registers, 128 threads a block, retiring on
  the gradient after its Hessian, solve and trials;
- the group design (``GROUP_KERNEL`` below, kept out of the source), the
  shipped kernel's staging and sweep with G lanes per element, N Hessian
  columns a dual pass, U passes a lane runs unrolled together and a cap on
  the registers a lane may take (255: no cap; 204, 168, 144 and 128 are at
  least 5, 6, 7 and 8 blocks of 64 threads an SM at G = 1, 168 and 128 at
  least 3 and 4 blocks of 128 at G > 1): G = 2, 3 and 6 at no cap, 168 and
  128; G = 1 at U = 1 (no cap, 168), 2 and 3 (no cap) and 6 (no cap, 204,
  168, 144, 128), at N = 2 and 3 (no cap, 168), N = 2 and U = 3, N = 3 and
  U = 2, N = 6 (at G = 1 and N U = 6 the lane keeps its triangle in
  registers, else in shared memory); U = 3 and N = 3 at G = 2, N = 2 at
  G = 3. G = 1, U = 6 at 168 registers is the shipped float build, G = 1,
  N = 2 with no cap the shipped double build;
- the queue (``QUEUE_KERNEL`` below, kept out of the source): Q elements a
  group, swept one after another, a group taking the next from its block's
  queue when its element is done (the group design's block of elements in
  1/Q of its threads), at G = 1 and Q = 2, G = 2 and Q = 2, G = 2 and
  Q = 4.

It prints each build's ``-Xptxas -v`` registers, stack, spills and shared
bytes for K1's kernels, then times every variant (median of 20 launches,
CUDA events) in turns forward and back, and holds every variant bit for bit
to ``prox2d_plain`` (exit 1 if one differs), on the step-0 prox inputs of Shoulder-320 in float32
and in float64 (409,600 slots) and on Monitor3320r's in float32 (265,004
triangles, through the stock engine's element-major entry). For each it
also prints how far the sweeps part within a group of warps: for a warp of
32, 16, 10 and 5 elements (1, 2, 3 and 6 lanes each) the Hessian phases
it runs over the Hessians its elements build (1: no element waits on
another's Hessian), and for a block of 64, 40 and 20 elements its sweeps
over its elements' sweeps (the block holds its SM until its last element
is done).

Prints the card's name and power limit first. Needs a CUDA card; run it
from the root of the repo.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "scripts"))

import chip_smoke as C  # noqa: E402
import sweep_divergence as SD  # noqa: E402
from mmadmm_tpu_torch import cuda_build  # noqa: E402
from mmadmm_tpu_torch.ops import prox2d as P  # noqa: E402

OUT = os.path.join(cuda_build.BUILD_DIR, "k1_variants")
LAUNCH = "template <typename R>\nint launch("

# The one-thread-per-element K1 as it was before the group design (its
# kernel and launch), on the source's ldlt, edet and maxnan.
THREAD_KERNEL = r"""
template <typename R>
__global__ void __launch_bounds__(128) prox2d_thread_kernel(
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
int launch_thread(const R* z, const R* dxpu, const R* free_, const R* cells, R* zout, R* ih0,
                  long long n, Consts<R> k, int max_iters, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  prox2d_thread_kernel<R><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      z, dxpu, free_, cells, zout, ih0, n, k, max_iters);
  return (int)cudaGetLastError();
}

"""

THREAD_ENTRY = r"""
extern "C" int mm_prox2d_thread(const float* z, const float* dxpu, const float* free_,
                                const float* cells, float* zout, float* ih0, long long n,
                                float h00, float h01, float h10, float h11, float w2,
                                float half_w2, float inv_w2, float tol, int max_iters,
                                void* stream) {
  return launch_thread<float>(z, dxpu, free_, cells, zout, ih0, n,
                              {h00, h01, h10, h11, w2, half_w2, inv_w2, tol}, max_iters, stream);
}

extern "C" int mm_prox2d_thread_f64(const double* z, const double* dxpu, const double* free_,
                                    const double* cells, double* zout, double* ih0, long long n,
                                    double h00, double h01, double h10, double h11, double w2,
                                    double half_w2, double inv_w2, double tol, int max_iters,
                                    void* stream) {
  return launch_thread<double>(z, dxpu, free_, cells, zout, ih0, n,
                               {h00, h01, h10, h11, w2, half_w2, inv_w2, tol}, max_iters,
                               stream);
}
"""

THREAD = "one thread per element"

# K1's group design, the variant this script keeps apart from the source: G
# lanes an element, N Hessian columns a dual pass, U passes a lane unrolled
# together, a cap of REGS registers a lane (255: none); at G = 1 and N U = 6
# a lane keeps its triangle in registers, else in shared memory. At G = 1 it
# is the shipped kernel with the per-type knobs as parameters.
GROUP_HELPERS = r"""
// A block stages 64, 64, 40 or 20 elements at G = 1, 2, 3, 6 (a warp holds
// 32 / G groups; at G = 3 and 6 its last 2 lanes idle), in 64 threads at
// G = 1, else 128.
template <int G>
constexpr int kK1GroupThreads = G == 1 ? 64 : 128;
template <int G>
constexpr int kK1Elements = kK1GroupThreads<G> / 32 * (32 / G);

// backtracking over the group, from the largest step down: trial a = 4 - t
// on lane t % G in round t / G, and the first round with an accepted trial
// gives the largest accepted alpha, 0 if none
template <int G, typename C, typename R>
__device__ __forceinline__ R backtrack_group(const R* z, const R* p, C cells, const R* dxpu,
                                             const Consts<R>& k, R e0, R det_floor, int lane,
                                             int base, unsigned gmask) {
#pragma unroll 1
  for (int r = 0; r * G < 5; ++r) {
    const int a = 4 - (r * G + lane);
    bool ok = false;
    if (a >= 0) {
      R zt[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) zt[i] = z[i] + alpha_bt<R>(a) * p[i];
      R ih_t, e_t;
      energy(zt, cells, dxpu, k, ih_t, e_t);
      ok = isfinite(e_t) && e_t <= e0 && edet(zt) > det_floor;
    }
    const unsigned votes = (__ballot_sync(gmask, ok) >> base) & ((1u << G) - 1u);
    if (votes) return alpha_bt<R>(4 - (r * G + __ffs(votes) - 1));
  }
  return R(0);
}

"""

GROUP_KERNEL = r"""
template <typename R, int G, int N, int U, int kRegs>
__global__ void __launch_bounds__(kK1GroupThreads<G>, 65536 / (kK1GroupThreads<G> * kRegs))
    prox2d_group_kernel(const R* __restrict__ z_in, const R* __restrict__ dxpu_in,
                        const R* __restrict__ free_in, const R* __restrict__ cells_in,
                        R* __restrict__ zout, R* __restrict__ ih0_out, long long n,
                        Consts<R> k, int max_iters) {
  static_assert(G == 1 || G == 2 || G == 3 || G == 6, "a group is 1, 2, 3 or 6 lanes");
  static_assert(6 % N == 0, "the Hessian's six columns in passes of N");
  constexpr int kT = kK1GroupThreads<G>, kE = kK1Elements<G>, kW = 32 / G;  // kW groups a warp
  constexpr bool kRegisters = G == 1 && N * U == 6;
  __shared__ __align__(16) Stage<R, kE, kRegisters ? 0 : kE> st;
  const long long first = (long long)blockIdx.x * kE;
  stage_rows<kE, kT>(st.cells, cells_in, kCells, n, first);
  stage_cols<kE, kT>(st.z, z_in, 6, n, first);
  stage_cols<kE, kT>(st.dxpu, dxpu_in, 6, n, first);
  stage_cols<kE, kT>(st.fr, free_in, 6, n, first);
  copies_done();
  __syncthreads();  // the block's only barrier: every lane below is in a live group

  const int wl = threadIdx.x % 32, grp = wl / G, lane = wl % G;
  if (grp >= kW) return;  // the last 2 lanes of a warp at G = 3 and 6
  const int el = threadIdx.x / 32 * kW + grp;
  const long long e = first + el;
  if (e >= n) return;
  const int base = grp * G;  // the group's first lane in its warp
  const unsigned gmask = ((1u << G) - 1u) << base;
  const SharedRows<R, kE> cells{st.cells + el};
  const R* dxpu = st.dxpu + el * 6;
  const R* fr = st.fr + el * 6;
  R z[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) z[c] = st.z[el * 6 + c];

  if (max_iters <= 0 && lane == 0) ih0_out[e] = energy_unreg(z, cells, k);
  for (int it = 0; it < max_iters; ++it) {
    R g[6];
    R ih;
    const R e0 = grad<R>(z, cells, dxpu, fr, k, g, ih);
    if (it == 0 && lane == 0) ih0_out[e] = ih;
    R gnorm = abs_(g[0]);
#pragma unroll
    for (int i = 1; i < 6; ++i) gnorm = gnorm + abs_(g[i]);
    if (it > 0 && gnorm < k.tol) break;

    R nb[6], p[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) nb[i] = -g[i];
    if constexpr (kRegisters) {
      R H[kTri];
#pragma unroll
      for (int j0 = 0; j0 < 6; j0 += N) hess_cols<N>(j0, z, cells, dxpu, fr, k, H);
      ldlt(H, nb, p);
    } else {
      // the passes spread over the group, U a lane unrolled together, into
      // the element's triangle in shared memory
      R* H = st.hess + el * kTri;
      __syncwarp(gmask);  // every lane has solved with the last sweep's triangle
#pragma unroll 1
      for (int j0 = lane * N; j0 < 6; j0 += G * N * U) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (j0 + u * G * N < 6) hess_cols<N>(j0 + u * G * N, z, cells, dxpu, fr, k, H);
      }
      __syncwarp(gmask);
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
    const R alpha = backtrack_group<G>(z, p, cells, dxpu, k, e0, det_floor, lane, base, gmask);
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
  for (int c = 0; c < 6; ++c)
    if (c % G == lane) zout[c * n + e] = z[c];
}

template <typename R, int G, int N, int U, int kRegs>
int launch_group(const R* z, const R* dxpu, const R* free_, const R* cells, R* zout, R* ih0,
                 long long n, Consts<R> k, int max_iters, void* stream) {
  if (n <= 0) return 0;
  constexpr int kT = kK1GroupThreads<G>, kE = kK1Elements<G>;
  const long long blocks = (n + kE - 1) / kE;
  prox2d_group_kernel<R, G, N, U, kRegs><<<(unsigned)blocks, kT, 0, (cudaStream_t)stream>>>(
      z, dxpu, free_, cells, zout, ih0, n, k, max_iters);
  return (int)cudaGetLastError();
}

"""

GROUP_ENTRY = r"""
extern "C" int mm_prox2d_group(const float* z, const float* dxpu, const float* free_,
                               const float* cells, float* zout, float* ih0, long long n,
                               float h00, float h01, float h10, float h11, float w2,
                               float half_w2, float inv_w2, float tol, int max_iters,
                               void* stream) {
  return launch_group<float, G_, N_, U_, REGS_>(z, dxpu, free_, cells, zout, ih0, n,
                                                {h00, h01, h10, h11, w2, half_w2, inv_w2, tol},
                                                max_iters, stream);
}

extern "C" int mm_prox2d_group_f64(const double* z, const double* dxpu, const double* free_,
                                   const double* cells, double* zout, double* ih0, long long n,
                                   double h00, double h01, double h10, double h11, double w2,
                                   double half_w2, double inv_w2, double tol, int max_iters,
                                   void* stream) {
  return launch_group<double, G_, N_, U_, REGS_>(z, dxpu, free_, cells, zout, ih0, n,
                                                 {h00, h01, h10, h11, w2, half_w2, inv_w2, tol},
                                                 max_iters, stream);
}
"""

# K1 with a block queue, the variant this script keeps apart from the source
QUEUE_KERNEL = r"""
// K1 with a queue: a block holds Q elements for each of its groups (the
// shipped block's elements in 1/Q of its threads), and a group that is done
// with its element takes the next from the block's queue.
template <int G, int Q>
constexpr int kQueueThreads = kK1GroupThreads<G> / Q;

template <typename R, int G, int Q>
__global__ void __launch_bounds__(kQueueThreads<G, Q>)
    prox2d_queue_kernel(const R* __restrict__ z_in, const R* __restrict__ dxpu_in,
                  const R* __restrict__ free_in, const R* __restrict__ cells_in,
                  R* __restrict__ zout, R* __restrict__ ih0_out, long long n, Consts<R> k,
                  int max_iters) {
  static_assert(G == 1 || G == 2 || G == 3 || G == 6, "a group is 1, 2, 3 or 6 lanes");
  constexpr int kT = kQueueThreads<G, Q>, kE = kK1Elements<G>, kW = 32 / G;  // kW groups a warp
  constexpr int kGroups = kT / 32 * kW;
  static_assert(kT % 32 == 0 && kGroups * Q == kE, "whole warps, Q elements a group");
  __shared__ __align__(16) Stage<R, kE, kE> st;
  __shared__ int next;  // the queue's next element
  const long long first = (long long)blockIdx.x * kE;
  stage_rows<kE, kT>(st.cells, cells_in, kCells, n, first);
  stage_cols<kE, kT>(st.z, z_in, 6, n, first);
  stage_cols<kE, kT>(st.dxpu, dxpu_in, 6, n, first);
  stage_cols<kE, kT>(st.fr, free_in, 6, n, first);
  if (threadIdx.x == 0) next = kGroups;
  copies_done();
  __syncthreads();  // the block's only barrier: every lane below is in a live group

  const int wl = threadIdx.x % 32, grp = wl / G, lane = wl % G;
  if (grp >= kW) return;  // the last 2 lanes of a warp at G = 3 and 6
  const int gi = threadIdx.x / 32 * kW + grp;  // the group's index in the block
  const int count = (int)(n - first < kE ? n - first : kE);
  const int base = grp * G;  // the group's first lane in its warp
  const unsigned gmask = ((1u << G) - 1u) << base;
  R* H = st.hess + gi * kTri;
  // the group's next element: lane 0 takes it from the queue
  auto take = [&]() {
    if (Q == 1) return count;
    int el = 0;
    if (lane == 0) el = atomicAdd(&next, 1);
    return __shfl_sync(gmask, el, base);
  };
  // z of element el from the stage
  auto load = [&](int el, R* z) {
#pragma unroll
    for (int c = 0; c < 6; ++c) z[c] = st.z[el * 6 + c];
  };
  // z out for element el, a channel a lane (z stays in registers)
  auto finish = [&](int el, const R* z) {
#pragma unroll
    for (int c = 0; c < 6; ++c)
      if (c % G == lane) zout[c * n + first + el] = z[c];
  };
  R z[6];
  int el = gi;
  if (max_iters <= 0) {
    for (; el < count; el = take()) {
      load(el, z);
      if (lane == 0) ih0_out[first + el] = energy_unreg(z, SharedRows<R, kE>{st.cells + el}, k);
      finish(el, z);
    }
    return;
  }
  if (el >= count) return;
  load(el, z);
  int it = 0;
  for (;;) {
    SharedRows<R, kE> cells{st.cells + el};
    const R* dxpu = st.dxpu + el * 6;
    const R* fr = st.fr + el * 6;
    // the gradient, its norm and the regularized energy at the start; an
    // element that retires on a small gradient (from its second sweep on)
    // leaves before moving and before the Hessian, which it would not use,
    // and the group goes on with the next element's gradient
    R g[6], e0;
    for (;;) {
      R ih;
      e0 = grad<R>(z, cells, dxpu, fr, k, g, ih);
      if (it == 0 && lane == 0) ih0_out[first + el] = ih;  // the energy at the input
      R gnorm = abs_(g[0]);
#pragma unroll
      for (int i = 1; i < 6; ++i) gnorm = gnorm + abs_(g[i]);
      if (!(it > 0 && gnorm < k.tol)) break;
      finish(el, z);
      el = take();
      if (el >= count) return;
      load(el, z);
      it = 0;
      cells = SharedRows<R, kE>{st.cells + el};
      dxpu = st.dxpu + el * 6;
      fr = st.fr + el * 6;
    }

    // the Hessian's columns, spread over the group
    __syncwarp(gmask);  // every lane has solved with the last sweep's triangle
#pragma unroll 1
    for (int j = lane; j < 6; j += G) hess_cols<1>(j, z, cells, dxpu, fr, k, H);
    __syncwarp(gmask);
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

    const R det0 = edet(z);
    const R det_floor = det0 < R(0) ? det0 : (det0 != det0 ? det0 : R(0));
    const R alpha = backtrack_group<G>(z, p, cells, dxpu, k, e0, det_floor, lane, base, gmask);
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
    if (stalled || ++it == max_iters) {
      finish(el, z);
      el = take();
      if (el >= count) return;
      load(el, z);
      it = 0;
    }
  }
}

template <typename R, int G, int Q>
int launch_queue(const R* z, const R* dxpu, const R* free_, const R* cells, R* zout, R* ih0,
                 long long n, Consts<R> k, int max_iters, void* stream) {
  if (n <= 0) return 0;
  constexpr int kT = kQueueThreads<G, Q>, kE = kK1Elements<G>;
  const long long blocks = (n + kE - 1) / kE;
  prox2d_queue_kernel<R, G, Q><<<(unsigned)blocks, kT, 0, (cudaStream_t)stream>>>(
      z, dxpu, free_, cells, zout, ih0, n, k, max_iters);
  return (int)cudaGetLastError();
}

"""

QUEUE_ENTRY = r"""
extern "C" int mm_prox2d_queue(const float* z, const float* dxpu, const float* free_,
                               const float* cells, float* zout, float* ih0, long long n,
                               float h00, float h01, float h10, float h11, float w2,
                               float half_w2, float inv_w2, float tol, int max_iters,
                               void* stream) {
  return launch_queue<float, G_, Q_>(z, dxpu, free_, cells, zout, ih0, n,
                                     {h00, h01, h10, h11, w2, half_w2, inv_w2, tol}, max_iters,
                                     stream);
}

extern "C" int mm_prox2d_queue_f64(const double* z, const double* dxpu, const double* free_,
                                   const double* cells, double* zout, double* ih0, long long n,
                                   double h00, double h01, double h10, double h11, double w2,
                                   double half_w2, double inv_w2, double tol, int max_iters,
                                   void* stream) {
  return launch_queue<double, G_, Q_>(z, dxpu, free_, cells, zout, ih0, n,
                                      {h00, h01, h10, h11, w2, half_w2, inv_w2, tol}, max_iters,
                                      stream);
}
"""


def _sub(s, old, new):
    if old not in s:
        raise RuntimeError(f"prox2d.cu has no {old!r}, which this script edits")
    return s.replace(old, new)


def _name(g, n, u, regs):
    return (f"G={g}" + (f", N={n}" if n > 1 else "") + (f", U={u}" if u > 1 else "") + ", "
            + ("no register cap" if regs == 255 else f"{regs} registers"))


def _group(g, n, u, regs):
    """The group kernel at g lanes, n columns a pass, u passes unrolled and
    a cap of regs registers, as ``mm_prox2d_group`` and
    ``mm_prox2d_group_f64``."""
    def edit(s):
        entry = GROUP_ENTRY
        for key, v in (("G_", g), ("N_", n), ("U_", u), ("REGS_", regs)):
            entry = entry.replace(key, str(v))
        return _sub(s, LAUNCH, GROUP_HELPERS + GROUP_KERNEL + LAUNCH) + entry
    return edit


def _queue(g, q):
    """The queue kernel at g lanes and q elements a group, as
    ``mm_prox2d_queue`` and ``mm_prox2d_queue_f64``."""
    def edit(s):
        entry = QUEUE_ENTRY.replace("G_", str(g)).replace("Q_", str(q))
        return _sub(s, LAUNCH, GROUP_HELPERS + QUEUE_KERNEL + LAUNCH) + entry
    return edit


# (G lanes an element, N Hessian columns a dual pass, U passes unrolled
# together, register cap)
VARIANTS = ([(1, 1, 1, 255), (1, 1, 1, 168), (1, 1, 2, 255), (1, 1, 3, 255), (1, 1, 6, 255),
             (1, 1, 6, 204), (1, 1, 6, 168), (1, 1, 6, 144), (1, 1, 6, 128)]
            + [(1, n, 1, regs) for n in (2, 3) for regs in (255, 168)]
            + [(1, 2, 3, 255), (1, 2, 3, 168), (1, 3, 2, 168), (1, 6, 1, 255), (1, 6, 1, 168)]
            + [(g, 1, 1, regs) for g in (2, 3, 6) for regs in (255, 168, 128)]
            + [(2, 1, 3, 168), (2, 3, 1, 255), (2, 3, 1, 168), (3, 2, 1, 255)])
# (lanes an element, elements a group)
QUEUES = [(1, 2), (2, 2), (2, 4)]
SHIPPED = "shipped (the source)"
BUILDS = {SHIPPED: lambda s: s,
          THREAD: lambda s: _sub(s, LAUNCH, THREAD_KERNEL + LAUNCH) + THREAD_ENTRY}
BUILDS.update({_name(*v): _group(*v) for v in VARIANTS})
BUILDS.update({f"queue, G={g}, Q={q}": _queue(g, q) for g, q in QUEUES})
# the C entry each build is timed through
ENTRY = {THREAD: "mm_prox2d_thread", **{_name(*v): "mm_prox2d_group" for v in VARIANTS},
         **{f"queue, G={g}, Q={q}": "mm_prox2d_queue" for g, q in QUEUES}}


def _ptxas(out: str):
    """``(kernel, registers, stack, spill stores, spill loads, shared
    bytes)`` of K1's kernels in an ``nvcc -Xptxas -v`` log."""
    rows, name, stack = [], None, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            stack = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if not (m and name):
            continue
        smem = re.search(r"(\d+) bytes smem", line)
        smem = int(smem.group(1)) if smem else 0
        s = re.search(r"prox2d_kernelI([fd])E", name)
        t = re.search(r"prox2d_group_kernelI([fd])Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", name)
        u = re.search(r"prox2d_thread_kernelI([fd])E", name)
        q = re.search(r"prox2d_queue_kernelI([fd])Li(\d+)ELi(\d+)E", name)
        if s:
            kernel = "K1 as shipped"
        elif t:
            kernel = (f"K1, {t.group(2)} lanes, {t.group(3)} columns a pass, {t.group(4)} "
                      f"unrolled, cap {t.group(5)}")
        elif u:
            kernel = f"K1, {THREAD}"
        elif q:
            kernel = f"K1 queue, {q.group(2)} lanes, {q.group(3)} elements a group"
        else:
            continue
        kernel += ", " + ("float64" if (s or t or u or q).group(1) == "d" else "float32")
        rows.append((kernel, int(m.group(1)), *stack, smem))
    return rows


def build_all():
    jobs = {}
    for i, (name, edit) in enumerate(BUILDS.items()):
        d = os.path.join(OUT, str(i))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC, d)
        src = os.path.join(d, "prox2d.cu")
        with open(src) as f:
            text = edit(f.read())
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(d, "libprox2d.so")
        proc = subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, so, time.perf_counter())
    libs = {}
    for name, (proc, so, t0) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        print(f"{name}: built in {time.perf_counter() - t0:.1f} s", flush=True)
        for kernel, regs, stack, st, ld, smem in _ptxas(out):
            print(f"  ptxas {kernel}: {regs} registers, {stack} bytes stack frame, {st} bytes "
                  f"spill stores, {ld} bytes spill loads, {smem} bytes shared", flush=True)
        lib = ctypes.CDLL(so)
        sigs = dict(P._SIGNATURES)
        if name in ENTRY:
            sigs[ENTRY[name]] = sigs["mm_prox2d"]
            sigs[ENTRY[name] + "_f64"] = sigs["mm_prox2d_f64"]
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
        libs[name] = lib
    return libs


def cases():
    """``{label: (inputs, args)}``: K1's step-0 inputs."""
    out = {}
    for dtype in ("float32", "float64"):
        integ = C.shoulder(320, dtype=dtype)[2]
        out[f"K1 at Shoulder-320 {dtype} step 0"] = C.prox_call(integ)
    m = C.monitor3320r()[2]
    out["K1 at Monitor3320r float32 step 0 (element-major entry)"] = (
        C.stock_inputs(m), (m.mesh.ehat_np.reshape(-1), m.w, m.prox_tol, m.prox_max_iters))
    return out


def divergence(inputs, args):
    """The Hessian phases of a warp of 32, 16, 10 and 5 elements over the
    Hessian builds, and the sweeps of a block of 64, 40 and 20 elements over
    the element-sweeps (see the module's note)."""
    sweeps, builds = SD.record(P.prox2d_plain, inputs, args, mod=P)
    n_built, n_sweeps = int(builds.sum()), int(sweeps.sum())
    warp = {k: k * int(SD.per_warp(builds, k).amax(-1).sum()) / n_built for k in (32, 16, 10, 5)}
    block = {k: k * int(SD.per_warp(sweeps, k).amax(-1).sum()) / n_sweeps for k in (64, 40, 20)}
    counts = torch.bincount(sweeps).tolist()
    return (f"{n_sweeps} element-sweeps, {n_built} Hessian builds; elements by sweeps run "
            f"{ {s: c for s, c in enumerate(counts) if c} }; Hessian phases of a warp of "
            f"32 / 16 / 10 / 5 elements: {' / '.join(f'{v:.4f}' for v in warp.values())}; "
            f"sweeps of a block of 64 / 40 / 20 elements: "
            f"{' / '.join(f'{v:.4f}' for v in block.values())}")


def main() -> int:
    if not torch.cuda.is_available():
        print("cuda_k1_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}; torch {torch.__version__}", flush=True)
    print(f"{len(BUILDS)} builds of prox2d.cu", flush=True)
    libs = build_all()
    order = list(BUILDS)
    differ = set()
    for label, (inputs, args) in cases().items():
        z, n = inputs[0], inputs[0].shape[1]
        f64 = z.dtype == torch.float64
        ehat, w, tol, max_iters = args
        w2, half_w2, inv_w2 = P._consts(w, z.dtype)
        consts = [float(v) for v in ehat] + [w2, half_w2, inv_w2, P.rnd(tol, z.dtype)]
        zp, ihp = P.prox2d_plain(*inputs, *args)
        ptrs = [t.data_ptr() for t in inputs]
        times = {v: [] for v in order}
        for v in order + order[::-1]:
            zo, ih = torch.empty_like(z), torch.empty(n, dtype=z.dtype, device=z.device)
            entry = ENTRY.get(v, "mm_prox2d") + ("_f64" if f64 else "")

            def call(fn=getattr(libs[v], entry), v=v):
                rc = fn(*ptrs, zo.data_ptr(), ih.data_ptr(), n, *consts, int(max_iters),
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{label}, {v}: CUDA error {rc}")

            times[v].append(C.time_kernel(call))
            if not (torch.equal(zo, zp) and torch.equal(ih, ihp)):
                differ.add((label, v))
        print(f"{label} ({n} slots): {divergence(inputs, args)}", flush=True)
        for v in order:
            equal = "NOT bit-equal" if (label, v) in differ else "bit-equal"
            print(f"  {v}: {' and '.join(f'{t:.4f}' for t in times[v])} ms, {equal}",
                  flush=True)
    print(f"{len(differ)} variant runs not bit-equal to the plain version", flush=True)
    return int(bool(differ))


if __name__ == "__main__":
    sys.exit(main())
