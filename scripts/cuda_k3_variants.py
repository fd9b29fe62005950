"""Kernel K3 (``csrc/be2d.cu``, ``hess2d_kernel<R>``) against the six-pass
design it replaced and every other layout this script knows, timed on the
card.

    python3 scripts/cuda_k3_variants.py [--turns=N] [--only='WORDS|...']

Builds, by plain ``nvcc`` into the git-ignored
``mmadmm_tpu_torch/_build/k3_variants/``, copies of ``csrc/``, all started
together (it prints how many):

- ``shipped``: ``be2d.cu`` as it is (one thread an element, its inputs
  staged in shared memory, one sparse column a pass; ``kK3Threads``,
  ``kK3Regs`` and ``kK3Rolled`` per real type);
- ``parent``: ``be2d.cu`` with the earlier K3 added (``PARENT_KERNEL``
  below, ``hess2d_parent_kernel<R>``: one thread an element, 128 a block,
  its 54 inputs in registers, six dual passes of one column each through
  ``grad<Dual<R>>``, the gradient regularized and masked as the prox's),
  as ``mm_hess2d_parent`` and ``mm_hess2d_parent_f64``;
- every layout of ``LAYOUTS`` below: ``be2d.cu`` with the laid-out K3
  added (``LAYOUT_KERNEL`` below, ``k3layout::hess2d_kernel<R, D>``, its
  float and double ``D`` set to the layout's ``HessLayout<threads a block,
  lanes an element G, Hessian columns a dual pass N, sparse samples, where
  the cells are read, register cap, rolled>``), as ``mm_hess2d_layout``
  and ``mm_hess2d_layout_f64``.

It prints each build's ``-Xptxas -v`` registers, stack, spills and shared
bytes for K3's kernels, then, on the step-0 inputs of the first K2/K3
call of Shoulder-320 in float32 and in float64 (409,600 slots; the Euler
integrator's, as ``chip_smoke.py`` takes them), times every build in
turns: each turn one run of 20 back-to-back launches of each build between
two CUDA events (so the host's call does not show between launches), the
order turned every turn, against the card's drift over a run; ``--turns``
turns (default 30), the median and quartiles of the ms a launch. K2
(``mm_eg2d``, the same in every build) is timed from the shipped build in
the same turns. Every build's output is held bit for bit (``torch.equal``)
to ``hess2d_plain``, and K2's to ``eg2d_plain``; it exits 1 if one differs
or fails to build. ``--only`` keeps the layouts
whose names contain one of the words (the parent and the shipped build
always run).

Prints the card's name and power limit first. Needs a CUDA card; run it
from the root of the repo.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as C  # noqa: E402
from mmadmm_tpu_torch import cuda_build  # noqa: E402
from mmadmm_tpu_torch.ops import be2d as B  # noqa: E402

OUT = os.path.join(cuda_build.BUILD_DIR, "k3_variants")
LAUNCH = "template <typename R>\nint launch_eg("

# The six-pass K3 as it was before the layouts (its kernel and launch).
PARENT_KERNEL = r"""
template <typename R>
__global__ void __launch_bounds__(128) hess2d_parent_kernel(
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

template <typename R>
int launch_hess_parent(const R* z, const R* cells, R* h, long long n, R h00, R h01, R h10,
                       R h11, void* stream) {
  if (n <= 0) return 0;
  Consts<R> k{h00, h01, h10, h11, R(0), R(0), R(0), R(0)};
  const long long blocks = (n + 127) / 128;
  hess2d_parent_kernel<R><<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(z, cells, h, n,
                                                                              k);
  return (int)cudaGetLastError();
}

"""

PARENT_ENTRY = r"""
extern "C" int mm_hess2d_parent(const float* z, const float* cells, float* h, long long n,
                                float h00, float h01, float h10, float h11, void* stream) {
  return launch_hess_parent<float>(z, cells, h, n, h00, h01, h10, h11, stream);
}

extern "C" int mm_hess2d_parent_f64(const double* z, const double* cells, double* h,
                                    long long n, double h00, double h01, double h10,
                                    double h11, void* stream) {
  return launch_hess_parent<double>(z, cells, h, n, h00, h01, h10, h11, stream);
}
"""

# K3 in every layout this script times, beside the shipped one: a thread an
# element or a group of G lanes, N Hessian columns a dual pass, the cells
# read from registers, the block's stage in shared memory or device memory.
# FLOAT_LAYOUT and DOUBLE_LAYOUT stand for the HessLayout of each real type.
LAYOUT_KERNEL = r"""
namespace k3layout {

constexpr int kTri = 21;  // entries of the lower triangle of a 6x6 matrix

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Where a thread reads its element's 48 cell channels: loaded into
// registers first; from the block's copy in shared memory, staged with
// cp.async; or from device memory (through L1) where each is used.
enum CellsFrom { kRegisters, kShared, kGlobal };

// kThreads threads a block; G lanes an element (1, 2, 3 or 6), each lane
// taking 6 / G consecutive Hessian columns; N columns a dual pass; kSparse,
// a pass samples the vertices it does not move as plain values; kFrom, where
// the cells are read (with G > 1 always kShared, the lanes of a group also
// gathering the triangle there); kRegs, the registers a thread may take
// (255: no cap); kRolled, a lane's passes run one by one in a loop.
template <int kThreads_, int G_, int N_, bool kSparse_, int kFrom_, int kRegs_ = 255,
          bool kRolled_ = false>
struct HessLayout {
  static constexpr int kThreads = kThreads_, G = G_, N = N_, kFrom = kFrom_, kRegs = kRegs_;
  static constexpr bool kSparse = kSparse_, kRolled = kRolled_;
  static constexpr int kCols = 6 / G;            // columns a lane
  static constexpr int kW = 32 / G;              // groups a warp (at G = 3 and 6 the
                                                 // last 2 lanes of a warp idle)
  static constexpr int kE = kThreads / 32 * kW;  // elements a block
  static constexpr int kMinBlocks = imax(1, 65536 / (kThreads * kRegs));
  static_assert(G == 1 || G == 2 || G == 3 || G == 6, "a group is 1, 2, 3 or 6 lanes");
  static_assert(kCols % N == 0, "a lane's columns in passes of N");
  static_assert(kThreads % 32 == 0, "whole warps");
  static_assert(!kSparse || N == 1 || (N == 2 && kCols % 2 == 0),
                "a sparse pass moves one vertex");
  static_assert(G == 1 || kFrom == kShared, "a group reads its element's cells from the stage");
  static_assert(!kRolled || kFrom != kRegisters, "cells in registers are indexed at compile time");
};

using FloatLayout = FLOAT_LAYOUT;
using DoubleLayout = DOUBLE_LAYOUT;
template <typename R>
using Layout = std::conditional_t<sizeof(R) == 4, FloatLayout, DoubleLayout>;

// One element's cell channels in device memory, [channel][n]: c[i] is
// channel i, read through L1 where it is used.
template <typename R>
struct GlobalRows {
  const R* p;  // the cells + the element's index
  long long n;
  __device__ __forceinline__ R operator[](int c) const { return __ldg(p + c * n); }
  __device__ __forceinline__ GlobalRows operator+(int c) const { return {p + c * n, n}; }
};

// A block's staged inputs, [channel][element] (SharedRows), and with G > 1
// its triangles, [entry][element].
template <typename R, class D>
struct HessStage {
  R cells[kCells * D::kE];
  R z[6 * D::kE];
  R h[D::G > 1 ? kTri * D::kE : 1];
};

// The monitor samples of a pass whose columns all move vertex v = j0 / 2:
// v's with the pass's tangents, the other two as plain values with zero
// tangents. Where v is known only at run time (a loop of passes, or a
// group's lanes) the tangents go in place by selects.
template <int N, typename C, typename R>
__device__ __forceinline__ void sparse_samples(int j0, const R* z, C cells,
                                               Common<DualN<R, N>>& t) {
  const int v = j0 / 2;
  DualN<R, N> x, y, s[3];
  x.v = v == 0 ? z[0] : (v == 1 ? z[2] : z[4]);
  y.v = v == 0 ? z[1] : (v == 1 ? z[3] : z[5]);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    x.d[q] = j0 + q == 2 * v ? R(1) : R(0);
    y.d[q] = j0 + q == 2 * v + 1 ? R(1) : R(0);
  }
  sample_m(cells + 16 * v, x, y, s[0], s[1], s[2]);
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    R p[3];
    sample_m(cells + 16 * u, z[2 * u], z[2 * u + 1], p[0], p[1], p[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      t.m[u][c].v = p[c];
#pragma unroll
      for (int q = 0; q < N; ++q) t.m[u][c].d[q] = u == v ? s[c].d[q] : R(0);
    }
  }
}

// Columns j0 .. j0 + N - 1 of the Hessian's lower triangle at z from one
// dual pass, entry (i, j) handed to out(tri(i, j), h)
template <int N, bool kSparse, typename C, typename R, typename Out>
__device__ __forceinline__ void hess_pass(int j0, const R* z, C cells, const Consts<R>& k,
                                          Out out) {
  DualN<R, N> zd[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    zd[i].v = z[i];
#pragma unroll
    for (int q = 0; q < N; ++q) zd[i].d[q] = i == j0 + q ? R(1) : R(0);
  }
  Common<DualN<R, N>> t;
  if constexpr (kSparse) {
    sparse_samples<N>(j0, z, cells, t);
  } else {
#pragma unroll
    for (int v = 0; v < 3; ++v)
      sample_m(cells + 16 * v, zd[2 * v], zd[2 * v + 1], t.m[v][0], t.m[v][1], t.m[v][2]);
  }
  common_tail(zd, k, t);
  DualN<R, N> raw[6];
  raw_grad(t, raw);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const int j = j0 + q;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (i < j) continue;
      const R h = raw[i].d[q];
      out(tri(i, j), i == j ? h + Num<R>::kLevenberg : h);
    }
  }
}

// a lane's passes, columns c0 .. c0 + D::kCols - 1 of its element
template <class D, typename C, typename R, typename Out>
__device__ __forceinline__ void lane_passes(int c0, const R* z, C cells, const Consts<R>& k,
                                            Out out) {
  if constexpr (D::kRolled) {
#pragma unroll 1
    for (int j0 = c0; j0 < c0 + D::kCols; j0 += D::N)
      hess_pass<D::N, D::kSparse>(j0, z, cells, k, out);
  } else {
#pragma unroll
    for (int j0 = c0; j0 < c0 + D::kCols; j0 += D::N)
      hess_pass<D::N, D::kSparse>(j0, z, cells, k, out);
  }
}

template <typename R, class D>
__global__ void __launch_bounds__(D::kThreads, D::kMinBlocks)
    hess2d_kernel(const R* __restrict__ z_in, const R* __restrict__ cells_in,
                  R* __restrict__ h_out, long long n, Consts<R> k) {
  constexpr int kE = D::kE;
  const long long first = (long long)blockIdx.x * kE;
  if constexpr (D::kFrom == kRegisters) {
    const long long e = first + threadIdx.x;
    if (e >= n) return;
    R z[6], cells[kCells];
    load_slot(z_in, cells_in, n, e, z, cells);
    lane_passes<D>(0, z, cells, k, [&](int c, R h) { h_out[c * n + e] = h; });
  } else if constexpr (D::kFrom == kGlobal) {
    const long long e = first + threadIdx.x;
    if (e >= n) return;
    R z[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) z[c] = z_in[c * n + e];
    lane_passes<D>(0, z, GlobalRows<R>{cells_in + e, n}, k,
                   [&](int c, R h) { h_out[c * n + e] = h; });
  } else {
    static_assert(sizeof(HessStage<R, D>) <= 48 * 1024, "static shared memory");
    __shared__ __align__(16) HessStage<R, D> st;
    stage_rows<kE, D::kThreads>(st.cells, cells_in, kCells, n, first);
    stage_rows<kE, D::kThreads>(st.z, z_in, 6, n, first);
    copies_done();
    __syncthreads();
    const int wl = threadIdx.x % 32, grp = wl / D::G, lane = wl % D::G;
    const int el = threadIdx.x / 32 * D::kW + grp;
    const long long e = first + el;
    if (grp < D::kW && e < n) {
      const SharedRows<R, kE> cells{st.cells + el};
      R z[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) z[c] = st.z[c * kE + el];
      if constexpr (D::G == 1)
        lane_passes<D>(0, z, cells, k, [&](int c, R h) { h_out[c * n + e] = h; });
      else  // the lane's columns into the block's triangles
        lane_passes<D>(lane * D::kCols, z, cells, k, [&](int c, R h) { st.h[c * kE + el] = h; });
    }
    if constexpr (D::G > 1) {
      __syncthreads();
      for (int q = threadIdx.x; q < kTri * kE; q += D::kThreads) {
        const int c = q / kE, i = q % kE;
        if (first + i < n) h_out[c * n + first + i] = st.h[c * kE + i];
      }
    }
  }
}

template <typename R>
int launch(const R* z, const R* cells, R* h, long long n, R h00, R h01, R h10, R h11,
           void* stream) {
  using D = Layout<R>;
  if (n <= 0) return 0;
  Consts<R> k{h00, h01, h10, h11, R(0), R(0), R(0), R(0)};
  const long long blocks = (n + D::kE - 1) / D::kE;
  hess2d_kernel<R, D><<<(unsigned)blocks, D::kThreads, 0, (cudaStream_t)stream>>>(
      z, cells, h, n, k);
  return (int)cudaGetLastError();
}

}  // namespace k3layout

"""

LAYOUT_ENTRY = r"""
extern "C" int mm_hess2d_layout(const float* z, const float* cells, float* h, long long n,
                                float h00, float h01, float h10, float h11, void* stream) {
  return k3layout::launch<float>(z, cells, h, n, h00, h01, h10, h11, stream);
}

extern "C" int mm_hess2d_layout_f64(const double* z, const double* cells, double* h,
                                    long long n, double h00, double h01, double h10,
                                    double h11, void* stream) {
  return k3layout::launch<double>(z, cells, h, n, h00, h01, h10, h11, stream);
}
"""

PARENT = "parent (six passes of one column)"
SHIPPED = "shipped (the source)"
K2 = "K2 eg2d, the shipped build"
FROM = ("registers", "shared memory", "device memory")  # LAYOUT_KERNEL's CellsFrom
# each build's float entry of K3 (double: + "_f64")
ENTRY = {SHIPPED: "mm_hess2d", PARENT: "mm_hess2d_parent", "layout": "mm_hess2d_layout"}

# name: HessLayout parameters, the same for float and double, or (float,
# double). At G = 1 a thread holds an element and reads its cells from
# registers (loaded first), from the block's copy in shared memory
# (staged) or from device memory where each is used (global); a block of
# 128 threads at 255 registers is 2 blocks = 8 warps an SM, a cap of 168
# registers 3, of 128 registers 4; a block of 64 threads 4, 6 and 8. At
# G > 1 the block stages its elements' inputs and gathers their triangles
# in shared memory. A double block of 128 threads does not stage within
# the 48 KB of static shared memory, so it stages 64. A sparse pass moves
# one vertex: N = 1, or N = 2 (a vertex's two columns).
LAYOUTS = {
    "G=1, N=1": "128, 1, 1, false, kRegisters",
    "G=1, N=1, sparse": "128, 1, 1, true, kRegisters",
    "G=1, N=2": "128, 1, 2, false, kRegisters",
    "G=1, N=2, sparse": "128, 1, 2, true, kRegisters",
    "G=1, N=2, sparse, 128 registers": "128, 1, 2, true, kRegisters, 128",
    "G=1, N=3": "128, 1, 3, false, kRegisters",
    "G=1, N=3, 168 registers": "128, 1, 3, false, kRegisters, 168",
    "G=1, N=6": "128, 1, 6, false, kRegisters",
    "G=1, N=6, 64 threads": "64, 1, 6, false, kRegisters",
    "G=1, N=6, 256 threads": "256, 1, 6, false, kRegisters",
    "G=1, N=6, 168 registers": "128, 1, 6, false, kRegisters, 168",
    "G=1, N=1, sparse, staged, 64 threads": "64, 1, 1, true, kShared",
    "G=1, N=1, sparse, staged, 64 threads, 192 registers": "64, 1, 1, true, kShared, 192",
    "G=1, N=1, sparse, staged, 64 threads, 168 registers": "64, 1, 1, true, kShared, 168",
    "G=1, N=1, sparse, staged, 64 threads, 144 registers": "64, 1, 1, true, kShared, 144",
    "G=1, N=1, sparse, staged, 64 threads, 128 registers": "64, 1, 1, true, kShared, 128",
    "G=1, N=2, sparse, staged, 64 threads": "64, 1, 2, true, kShared",
    "G=1, N=2, sparse, staged, 64 threads, 168 registers": "64, 1, 2, true, kShared, 168",
    "G=1, N=2, sparse, staged, 64 threads, 128 registers": "64, 1, 2, true, kShared, 128",
    "G=1, N=3, staged, 64 threads": "64, 1, 3, false, kShared",
    "G=1, N=3, staged, 64 threads, 168 registers": "64, 1, 3, false, kShared, 168",
    "G=1, N=3, staged, 64 threads, 128 registers": "64, 1, 3, false, kShared, 128",
    "G=1, N=6, staged, 64 threads": "64, 1, 6, false, kShared",
    "G=1, N=6, staged, 64 threads, 168 registers": "64, 1, 6, false, kShared, 168",
    "G=1, N=6, staged, 64 threads, 128 registers": "64, 1, 6, false, kShared, 128",
    "G=1, N=1, sparse, staged, 128 threads, 168 registers (double rolled, 32)":
        ("128, 1, 1, true, kShared, 168", "32, 1, 1, true, kShared, 255, true"),
    "G=1, N=2, sparse, staged, 128 threads (double 64)":
        ("128, 1, 2, true, kShared", "64, 1, 2, true, kShared"),
    "G=1, N=6, staged, 128 threads (double 64)":
        ("128, 1, 6, false, kShared", "64, 1, 6, false, kShared"),
    "G=1, N=1, sparse, staged, rolled, 32 threads": "32, 1, 1, true, kShared, 255, true",
    "G=1, N=1, sparse, staged, rolled, 64 threads": "64, 1, 1, true, kShared, 255, true",
    "G=1, N=1, sparse, staged, rolled, 64 threads, 168 registers":
        "64, 1, 1, true, kShared, 168, true",
    "G=1, N=1, sparse, staged, rolled, 64 threads, 128 registers":
        "64, 1, 1, true, kShared, 128, true",
    "G=1, N=1, sparse, staged, rolled, 64 threads, 96 registers":
        "64, 1, 1, true, kShared, 96, true",
    "G=1, N=1, sparse, staged, rolled, 128 threads, 128 registers (double 64, 168)":
        ("128, 1, 1, true, kShared, 128, true", "64, 1, 1, true, kShared, 168, true"),
    "G=1, N=2, sparse, staged, rolled, 64 threads": "64, 1, 2, true, kShared, 255, true",
    "G=1, N=2, sparse, staged, rolled, 64 threads, 168 registers":
        "64, 1, 2, true, kShared, 168, true",
    "G=1, N=2, sparse, staged, rolled, 64 threads, 128 registers":
        "64, 1, 2, true, kShared, 128, true",
    "G=1, N=1, sparse, global": "128, 1, 1, true, kGlobal",
    "G=1, N=1, sparse, global, 128 registers": "128, 1, 1, true, kGlobal, 128",
    "G=1, N=2, sparse, global": "128, 1, 2, true, kGlobal",
    "G=1, N=2, sparse, global, 128 registers": "128, 1, 2, true, kGlobal, 128",
    "G=1, N=3, global": "128, 1, 3, false, kGlobal",
    "G=1, N=6, global": "128, 1, 6, false, kGlobal",
    "G=1, N=6, global, 168 registers": "128, 1, 6, false, kGlobal, 168",
    "G=1, N=1, sparse, global, rolled": "128, 1, 1, true, kGlobal, 255, true",
    "G=1, N=1, sparse, global, rolled, 168 registers": "128, 1, 1, true, kGlobal, 168, true",
    "G=1, N=2, sparse, global, rolled": "128, 1, 2, true, kGlobal, 255, true",
    "G=2, N=1, sparse": "128, 2, 1, true, kShared",
    "G=2, N=3": "128, 2, 3, false, kShared",
    "G=3, N=1, sparse": "128, 3, 1, true, kShared",
    "G=3, N=2": "128, 3, 2, false, kShared",
    "G=3, N=2, sparse": "128, 3, 2, true, kShared",
    "G=3, N=2, sparse, 256 threads": "256, 3, 2, true, kShared",
    "G=3, N=2, sparse, 128 registers": "128, 3, 2, true, kShared, 128",
    "G=6, N=1": "128, 6, 1, false, kShared",
    "G=6, N=1, sparse": "128, 6, 1, true, kShared",
    "G=6, N=1, sparse, 256 threads": "256, 6, 1, true, kShared",
    "G=6, N=1, sparse, 96 registers": "128, 6, 1, true, kShared, 96",
}
LAYOUTS = {name: tuple(f"HessLayout<{p}>" for p in ((v, v) if isinstance(v, str) else v))
           for name, v in LAYOUTS.items()}


def _sub(s, old, new):
    if old not in s:
        raise RuntimeError(f"be2d.cu has no {old!r}, which this script edits")
    return s.replace(old, new)


def with_parent(src: str) -> str:
    """``be2d.cu`` with the six-pass K3 and its entries added."""
    return _sub(src, LAUNCH, PARENT_KERNEL + LAUNCH) + PARENT_ENTRY


def with_layouts(src: str, float_layout: str, double_layout: str) -> str:
    """``be2d.cu`` with K3 added in the given float and double layouts
    (``LAYOUT_KERNEL``, ``mm_hess2d_layout`` and ``mm_hess2d_layout_f64``)."""
    text = (LAYOUT_KERNEL.replace("FLOAT_LAYOUT", float_layout)
            .replace("DOUBLE_LAYOUT", double_layout))
    src = src if "#include <type_traits>" in src else "#include <type_traits>\n" + src
    return _sub(src, LAUNCH, text + LAUNCH) + LAYOUT_ENTRY


BUILDS = {SHIPPED: lambda s: s, PARENT: with_parent}
BUILDS.update({name: (lambda s, f=f, d=d: with_layouts(s, f, d))
               for name, (f, d) in LAYOUTS.items()})


def _ptxas(out: str):
    """``(build, kernel, registers, stack, spill stores, spill loads,
    shared bytes)`` of K3's kernels in an ``nvcc -Xptxas -v`` log, ``build``
    the shipped one, the parent or ``"layout"``."""
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
        s = re.search(r"hess2d_kernelI([fd])N\w*?10HessLayoutILi(\d+)ELi(\d+)ELi(\d+)ELb([01])"
                      r"ELi(\d)ELi(\d+)ELb([01])E", name)
        p = re.search(r"hess2d_parent_kernelI([fd])E", name)
        h = re.search(r"hess2d_kernelI([fd])EEvPK", name)
        if s:
            build = "layout"
            kernel = (f"K3 {s.group(2)} threads, G={s.group(3)}, N={s.group(4)}, sparse "
                      f"{s.group(5)}, cells from {FROM[int(s.group(6))]}, cap {s.group(7)}, "
                      f"rolled {s.group(8)}")
        elif p:
            build, kernel = PARENT, "K3 parent"
        elif h:
            build, kernel = SHIPPED, "K3 as shipped"
        else:
            continue
        kernel += ", " + ("float64" if (s or p or h).group(1) == "d" else "float32")
        rows.append((build, kernel, int(m.group(1)), *stack, smem))
    return rows


def build_all(builds):
    jobs = {}
    for i, (name, edit) in enumerate(builds.items()):
        d = os.path.join(OUT, str(i))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC, d)
        src = os.path.join(d, "be2d.cu")
        with open(src) as f:
            text = edit(f.read())
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(d, "libbe2d.so")
        proc = subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, so, time.perf_counter())
    libs, failed = {}, []
    for name, (proc, so, t0) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed\n{out}", flush=True)
            failed.append(name)
            continue
        print(f"{name}: built in {time.perf_counter() - t0:.1f} s", flush=True)
        for build, kernel, regs, stack, st, ld, smem in _ptxas(out):
            if build != name and (build != "layout" or name in (SHIPPED, PARENT)):
                continue  # the shipped K3, which every build holds
            print(f"  ptxas {kernel}: {regs} registers, {stack} bytes stack frame, {st} bytes "
                  f"spill stores, {ld} bytes spill loads, {smem} bytes shared", flush=True)
        lib = ctypes.CDLL(so)
        sigs = dict(B._SIGNATURES)
        entry = ENTRY.get(name, ENTRY["layout"])
        sigs[entry], sigs[entry + "_f64"] = sigs["mm_hess2d"], sigs["mm_hess2d_f64"]
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
        libs[name] = lib
    return libs, failed


def cases():
    """``{label: (z, cells, ehat)}``: the inputs of the first K2/K3 call of
    step 0 at Shoulder-320, in float32 and float64."""
    return {f"K3 at Shoulder-320 {dtype} step 0": C.be_inputs(C.shoulder(320, 1, dtype=dtype)[2])
            for dtype in ("float32", "float64")}


def main() -> int:
    if not torch.cuda.is_available():
        print("cuda_k3_variants: no CUDA device", file=sys.stderr)
        return 1
    opts = dict(a[2:].split("=", 1) for a in sys.argv[1:] if a.startswith("--") and "=" in a)
    turns = int(opts.get("turns", 30))
    only = [w for w in opts.get("only", "").split("|") if w]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}; torch {torch.__version__}", flush=True)
    builds = {name: b for name, b in BUILDS.items()
              if name in (SHIPPED, PARENT) or not only or any(w in name for w in only)}
    print(f"{len(builds)} builds of be2d.cu", flush=True)
    libs, failed = build_all(builds)
    order = list(libs)
    for label, (z, cells, ehat) in cases().items():
        n, f64 = z.shape[1], z.dtype == torch.float64
        consts = [float(v) for v in ehat]
        hp = B.hess2d_plain(z, cells, ehat)
        outs, launch = {}, {}
        # K2 from the shipped build, timed in the same turns
        g, ih = torch.empty_like(z), torch.empty(n, dtype=z.dtype, device=z.device)

        def call_k2(fn=getattr(libs[SHIPPED], "mm_eg2d" + ("_f64" if f64 else ""))):
            rc = fn(z.data_ptr(), cells.data_ptr(), g.data_ptr(), ih.data_ptr(), n, *consts,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{label}, K2: CUDA error {rc}")
        launch[K2] = call_k2
        for v in order:
            h = torch.empty((21, n), dtype=z.dtype, device=z.device)
            outs[v] = h
            entry = ENTRY.get(v, ENTRY["layout"]) + ("_f64" if f64 else "")

            def call(fn=getattr(libs[v], entry), h=h, v=v):
                rc = fn(z.data_ptr(), cells.data_ptr(), h.data_ptr(), n, *consts,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{label}, {v}: CUDA error {rc}")
            launch[v] = call
        timed = [K2, *order]
        for v in timed:  # a warm-up launch of each
            launch[v]()
        times = {v: [] for v in timed}
        for i in range(turns):
            for v in timed if i % 2 == 0 else timed[::-1]:
                times[v].append(C.time_launches(launch[v]))
        torch.cuda.synchronize()
        print(f"{label} ({n} slots), ms a launch over {turns} turns of 20 back-to-back "
              f"launches:", flush=True)
        gp, ihp = B.eg2d_plain(z, cells, ehat)
        for v in timed:
            q = statistics.quantiles(times[v], n=4)
            equal = (torch.equal(g, gp) and torch.equal(ih, ihp) if v == K2
                     else torch.equal(outs[v], hp))
            if not equal:
                failed.append(f"{label}, {v}")
            print(f"  {v}: median {statistics.median(times[v]):.4f} ms (quartiles {q[0]:.4f}, "
                  f"{q[2]:.4f}), " + ("bit-equal" if equal else "NOT bit-equal"), flush=True)
    if failed:
        print(f"failed: {failed}", flush=True)
    return int(bool(failed))


if __name__ == "__main__":
    sys.exit(main())
