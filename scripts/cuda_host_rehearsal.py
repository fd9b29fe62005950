"""Run kernels K1-K4, K4' and K4'' as host code against their plain
PyTorch versions, in float32 and in float64, as the card builds them: a
rehearsal of their arithmetic where there is no card and no ``nvcc``.

    python scripts/cuda_host_rehearsal.py [prox2d] [be2d] [prox3d]

Naming sources runs only their kernels (all three by default). Compiles
``mmadmm_tpu_torch/csrc/prox2d.cu``, ``be2d.cu`` and ``prox3d.cu`` with
``g++ -ffp-contract=off`` (no fused multiply-add, as ``nvcc
--fmad=false``) against a stub ``cuda_runtime.h`` that defines
``__device__``, ``__ldg``, ``threadIdx`` and the like as host code, into a
temporary directory, each kernel through one ``extern "C"`` entry per real
type. K2 and the six-pass K3 that ``scripts/cuda_k3_variants.py``
generates (``PARENT_KERNEL``) are called once per element, one after
another; K3 as shipped, and in every layout of that script's ``LAYOUTS``
(one library each) a block at a time with one host thread per lane, at
all columns and at 1, E - 1, E and E + 1 (E the layout's elements a
block). The kernels where a group of lanes shares an
element run a block at a time with one host thread per lane
(``threadIdx`` is thread-local), ``__syncthreads``, ``__syncwarp`` and
``__ballot_sync`` being host barriers over the block or the mask's lanes,
and ``__shfl_sync`` of a real an exchange between two of them:
K1 as shipped (one thread an element, 64 a block) and the group design
that ``scripts/cuda_k1_variants.py`` builds beside it (``GROUP_KERNEL``
there) with 1, 2, 3 and 6 lanes per element and one Hessian column a dual
pass, with 2, 3 and 6 columns a pass at 1 lane, 3 at 2 lanes and 2 at 3
lanes, and with 2, 3 and 6 passes unrolled together at 1 lane and 3 at 2
lanes, the 3D kernels in their shipped layouts (``Build`` in
``prox3d.cu``) and at other group widths (the Newton kernels K4 and K4''b
at 4, 8 and 16 lanes, the chord kernels K4' and K4''a at 2, 4 and 8), and
the four in float64 also in every layout and source edit that
``scripts/cuda_k4_variants.py`` times for them (its ``NEWTON64``,
``CHORD64``, ``COMP64`` and ``CHORD_BOX64``, and the parent's layouts; a
dynamic stage is a static array here); each also on the first 1, 30 and
131 columns of its inputs as shipped (the block's copies then take the
one-value path), and the four in float64 on kE - 1 and kE + 1 columns (kE
their elements a block), on a block of carved slots (free all 0; the
first block's free set to 0 where the mesh has no carved slot) and with
max_iters 1. The 3D kernels are
compiled without their C entries, one library per entry, real type and
set of source edits, all together. Their outputs
are compared bit for bit with ``prox2d_plain``, ``eg2d_plain`` and
``hess2d_plain`` (Shoulder nx=16), ``prox3d_plain`` (3D SquareGrid and
Shoulder nx=4 and SquareGrid nx=6), ``prox3d_chord_comp_plain`` (3D
SquareGrid nx=4 and 6 on a computational mesh, mon_type 5, rho 10, through
the stock engine's element-major blocks), ``prox3d_chord_plain`` (3D
SquareGrid nx=4 with ``prox_chord=True``) and ``prox3d_comp_plain`` (the
nx=4 computational mesh with ``prox_chord=False``), on the step-0 prox
inputs with their dual perturbed by a seeded normal; then all of them
again in float64: K1-K4 on the float64 stencil engines' inputs, K4', K4''a
and K4''b on the float64 stock engine's (``prox_backend="pallas"``). PyTorch's CPU ``sqrt``
need not be correctly rounded in either dtype (the card's is, like the
kernels'), so the script first prints the share of f32 and f64 square
roots where it differs from the correctly rounded one, then runs the
plain versions with a correctly rounded square root. Exits 1 unless every
run is bit-equal. Needs ``g++``; runs on the CPU.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "scripts"))

import cuda_k1_variants as K1V  # noqa: E402
import cuda_k3_variants as K3V  # noqa: E402
import cuda_k4_variants as K4V  # noqa: E402

from mmadmm_tpu_torch import ExperimentConfig, build_problem  # noqa: E402
from mmadmm_tpu_torch.cuda_build import CSRC  # noqa: E402
from mmadmm_tpu_torch.ops.monitor_grid import element_cell_rows  # noqa: E402
from mmadmm_tpu_torch.ops import be2d as B  # noqa: E402
from mmadmm_tpu_torch.ops import newton as N  # noqa: E402
from mmadmm_tpu_torch.ops import prox2d as P2  # noqa: E402
from mmadmm_tpu_torch.ops import prox3d as P3  # noqa: E402

STUB = """#pragma once
#include <array>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __shared__ static
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
typedef void* cudaStream_t;
struct Dim3 { unsigned x, y, z; };
static thread_local Dim3 threadIdx;
static Dim3 blockIdx, blockDim;
template <typename T> T __ldg(const T* p) { return *p; }
inline int cudaGetLastError() { return 0; }
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9
};
enum cudaError { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
template <typename T> int cudaFuncSetAttribute(T*, cudaFuncAttribute, int) { return 0; }
template <typename T> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, T*, int, size_t) {
  *b = 0;
  return 0;
}
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
using std::isfinite;

// A barrier of `count` host threads, one per lane, that returns the OR of
// the words they bring: __syncthreads, __syncwarp and __ballot_sync.
struct HostBarrier {
  std::mutex m;
  std::condition_variable cv;
  int count = 0, arrived = 0;
  unsigned long gen = 0;
  unsigned acc = 0, result = 0;
  unsigned arrive(unsigned v) {
    std::unique_lock<std::mutex> lk(m);
    acc |= v;
    const unsigned long g = gen;
    if (++arrived == count) {
      result = acc;
      acc = 0;
      arrived = 0;
      ++gen;
      cv.notify_all();
      return result;
    }
    cv.wait(lk, [&] { return gen != g; });
    return result;
  }
};

inline HostBarrier& host_barrier(unsigned warp, unsigned mask, int count) {
  static std::mutex m;
  static std::map<std::tuple<unsigned, unsigned, int>, HostBarrier> bars;
  std::lock_guard<std::mutex> lk(m);
  auto it = bars.find({warp, mask, count});
  if (it == bars.end()) {
    it = bars.try_emplace({warp, mask, count}).first;
    it->second.count = count;
  }
  return it->second;
}

inline void __syncthreads() { host_barrier(~0u, 0u, (int)blockDim.x).arrive(0u); }
inline void __syncwarp(unsigned mask) {
  host_barrier(threadIdx.x / 32, mask, __builtin_popcount(mask)).arrive(0u);
}
inline unsigned __ballot_sync(unsigned mask, bool p) {
  return host_barrier(threadIdx.x / 32, mask, __builtin_popcount(mask))
      .arrive(p ? 1u << (threadIdx.x % 32) : 0u);
}
// the value v >= 0 of lane src of the mask's lanes
inline int __shfl_sync(unsigned mask, int v, int src) {
  return (int)host_barrier(threadIdx.x / 32, mask, __builtin_popcount(mask))
      .arrive((int)(threadIdx.x % 32) == src ? (unsigned)v : 0u);
}
// the real v of lane src of the mask's lanes: each lane's bits through a
// slot of its warp's, between two barriers of the mask's lanes
template <typename T>
inline T shfl_real(unsigned mask, T v, int src) {
  static std::mutex m;
  static std::map<unsigned, std::array<T, 32>> slots;
  T* slot;
  {
    std::lock_guard<std::mutex> lk(m);
    slot = slots[threadIdx.x / 32].data();
  }
  HostBarrier& bar = host_barrier(threadIdx.x / 32, mask, __builtin_popcount(mask));
  slot[threadIdx.x % 32] = v;
  bar.arrive(0u);
  const T out = slot[src];
  bar.arrive(0u);
  return out;
}
inline float __shfl_sync(unsigned mask, float v, int src) { return shfl_real(mask, v, src); }
inline double __shfl_sync(unsigned mask, double v, int src) { return shfl_real(mask, v, src); }
"""

# one host entry per kernel and real type: the launch becomes a loop over
# the elements (the one-thread kernels) or over the blocks (the group
# kernels); each entry exists as host_<name>_f32 and host_<name>_f64
HOST_ENTRIES = {
    "prox2d": """
#include <thread>
#include <vector>

// a kernel of kT threads a block over the blocks of kE elements, one host
// thread per lane
template <int kT, int kE, typename F>
int host_blocks(long long n, F kernel) {
  blockDim.x = kT;
  for (long long b = 0; b * kE < n; ++b) {
    blockIdx.x = b;
    std::vector<std::thread> lanes;
    for (unsigned t = 0; t < (unsigned)kT; ++t)
      lanes.emplace_back([=] {
        threadIdx.x = t;
        kernel();
      });
    for (auto& l : lanes) l.join();
  }
  return 0;
}

// gnu = 0: K1 as shipped; else 100 G + 10 N + U: the group design of
// scripts/cuda_k1_variants.py with G lanes an element, N Hessian columns a
// dual pass and U passes a lane unrolled together
template <typename R>
int host_prox2d(int gnu, const R* z, const R* dxpu, const R* fr, const R* cells, R* zout,
                R* ih0, long long n, const R* c, int max_iters) {
  Consts<R> k{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7]};
  if (gnu == 0)
    return host_blocks<kK1Threads, kK1Threads>(n, [=] {
      prox2d_kernel<R>(z, dxpu, fr, cells, zout, ih0, n, k, max_iters);
    });
  switch (gnu) {
#define K1_AT(G, N, U)                                                                  \
    case 100 * G + 10 * N + U:                                                          \
      return host_blocks<kK1GroupThreads<G>, kK1Elements<G>>(n, [=] {                   \
        prox2d_group_kernel<R, G, N, U, 255>(z, dxpu, fr, cells, zout, ih0, n, k, max_iters); \
      });
    K1_AT(1, 1, 1) K1_AT(2, 1, 1) K1_AT(3, 1, 1) K1_AT(6, 1, 1) K1_AT(1, 2, 1) K1_AT(1, 3, 1)
    K1_AT(1, 6, 1) K1_AT(2, 3, 1) K1_AT(3, 2, 1) K1_AT(1, 1, 2) K1_AT(1, 1, 3) K1_AT(1, 1, 6)
    K1_AT(2, 1, 3) K1_AT(1, 2, 3)
#undef K1_AT
  }
  return 1;
}
""",
    "be2d": """
#include <thread>
#include <vector>

// a kernel of kT threads a block over the blocks of kE elements, one host
// thread per lane
template <int kT, int kE, typename F>
int host_blocks(long long n, F kernel) {
  blockDim.x = kT;
  for (long long b = 0; b * kE < n; ++b) {
    blockIdx.x = b;
    std::vector<std::thread> lanes;
    for (unsigned t = 0; t < (unsigned)kT; ++t)
      lanes.emplace_back([=] {
        threadIdx.x = t;
        kernel();
      });
    for (auto& l : lanes) l.join();
  }
  return 0;
}

// code 0: K2 (out is g [6, n] then ih [n]); 1: K3 as shipped (out is
// H [21, n]); 2: the six-pass K3 of scripts/cuda_k3_variants.py
// (PARENT_KERNEL), in the unit that has it; 3: K3 in the layout of that
// script's LAYOUT_KERNEL that the unit builds
template <typename R>
int host_be2d(int code, const R* z, const R* cells, R* out, long long n, const R* c) {
  Consts<R> k{c[0], c[1], c[2], c[3], R(0), R(0), R(0), R(0)};
  constexpr int kE = kK3Threads<R>;
  if (code == 1)
    return host_blocks<kE, kE>(n, [=] { hess2d_kernel<R>(z, cells, out, n, k); });
  if (code == 3) LAYOUT_CALL;
  if (code != 0 && code != 2) return 1;
  blockDim.x = 128;
  for (long long e = 0; e < n; ++e) {
    blockIdx.x = e / 128; threadIdx.x = e % 128;
    if (code == 0)
      eg2d_kernel<R>(z, cells, out, out + 6 * n, n, k);
    else
      PARENT_CALL;
  }
  return 0;
}
""",
    "prox3d": """
#include <thread>
#include <vector>

// a kernel laid out as D: a block of D::kThreads lanes at a time, one host
// thread per lane
template <typename R, bool kChord, bool kComp, class D>
int host_layout(const R* z, const R* dxpu, const R* fr, const R* cells, const R* ehat, R* zout,
                R* ih0, long long n, const R* c, int max_iters) {
  Ehat3<R> eh{};
  Consts3<R> k;
  if (!kComp) std::memcpy(&eh, c, sizeof(eh));
  std::memcpy(&k, c + (kComp ? 0 : 9), sizeof(k));
  blockDim.x = D::kThreads;
  for (long long b = 0; b * D::kE < n; ++b) {
    blockIdx.x = b;
    std::vector<std::thread> lanes;
    for (unsigned t = 0; t < (unsigned)D::kThreads; ++t)
      lanes.emplace_back([=] {
        threadIdx.x = t;
        if constexpr (kChord)
          prox3d_chord_kernel<R, kComp, D>(z, dxpu, fr, cells, ehat, zout, ih0, n, eh, k,
                                           max_iters);
        else
          prox3d_newton_kernel<R, kComp, D>(z, dxpu, fr, cells, ehat, zout, ih0, n, eh, k,
                                            max_iters);
      });
    for (auto& l : lanes) l.join();
  }
  return 0;
}

// a build's layout at G lanes an element, with no register cap: the Newton
// kernels keep their threads a block, the chord kernels their elements
template <class L, int G>
using NewtonAt = Layout<L::kThreads, G, 1, L::kFactor>;
template <class L, int G>
using ChordAt = Layout<L::kE * G, G, 1, L::kFactor>;
""",
}

# each template entry in float and double, with a C name: (arguments
# before the real pointers, real pointers, then the tail)
ENTRY_ARGS = {
    "host_prox2d": ("int", 6), "host_be2d": ("int", 3), "host_prox3d": ("int", 6),
    "host_prox3d_chord": ("int", 6), "host_prox3d_chord_comp": ("int", 7),
    "host_prox3d_comp": ("int", 7),
}


def _c_entries(name):
    """``extern "C"`` wrappers of the template entries of ``name``'s source,
    host_<entry>_f32 and host_<entry>_f64."""
    out = []
    for entry, (lead, nptr) in ENTRY_ARGS.items():
        if f"int {entry}(" not in HOST_ENTRIES[name]:
            continue
        for suffix, real in (("f32", "float"), ("f64", "double")):
            params = ([f"int a{i}" for i in range(1 if lead else 0)]
                      + [f"{real}* p{i}" for i in range(nptr)])
            args = [f"a{i}" for i in range(1 if lead else 0)] + [f"p{i}" for i in range(nptr)]
            if entry == "host_be2d":
                params += ["long long n", f"const {real}* c"]
                args += ["n", "c"]
            else:
                params += ["long long n", f"const {real}* c", "int max_iters"]
                args += ["n", "c", "max_iters"]
            out.append(f'extern "C" int {entry}_{suffix}({", ".join(params)}) {{\n'
                       f'  return {entry}<{real}>({", ".join(args)});\n}}\n')
    return "".join(out)


# the K1 runs: 0 as shipped, else 100 x lanes an element + 10 x Hessian
# columns a dual pass + passes unrolled together (the group design)
K1_RUNS = (0, 111, 211, 311, 611, 121, 131, 161, 231, 321, 112, 113, 116, 213, 123)
# the 3D entries: (chord, comp) of their kernel
ENTRIES3D = {"host_prox3d": (False, False), "host_prox3d_comp": (False, True),
             "host_prox3d_chord": (True, False), "host_prox3d_chord_comp": (True, True)}
# the 3D kernels in float64 run every variant the timer builds for them:
# [(label, (layout, text edits))]
TIMED64 = {("host_prox3d", "double"): [(K4V.PARENT, (K4V.PARENT_K4, ())),
                                       *K4V.NEWTON64.items()],
           ("host_prox3d_chord_comp", "double"): [(K4V.PARENT, (K4V.PARENT_K4C, ())),
                                                  *K4V.CHORD64.items()],
           ("host_prox3d_comp", "double"): [(K4V.PARENT, (K4V.PARENT_K4PPB, ())),
                                            *K4V.COMP64.items()],
           ("host_prox3d_chord", "double"): [(K4V.PARENT, (K4V.PARENT_K4PPA, ())),
                                             *K4V.CHORD_BOX64.items()]}


def variants3d(entry, real):
    """``[(text edits, [(label, C++ layout)])]`` that a 3D entry runs in
    ``real``, by the edits of the source they need (none first): the
    shipped layout, its kernel at other group widths (the Newton kernels at
    4, 8 and 16 lanes, the chord kernels at 2, 4 and 8), then in float64 the
    variant timer's."""
    chord, comp = ENTRIES3D[entry]
    shipped = f"Build<{real}, {str(chord).lower()}, {str(comp).lower()}>::L"
    at = "ChordAt" if chord else "NewtonAt"
    groups = {(): [("as shipped", shipped)]
              + [(f"{g} lanes per element", f"{at}<{shipped}, {g}>")
                 for g in ((2, 4, 8) if chord else (4, 8, 16))]}
    for label, (layout, edits) in TIMED64.get((entry, real), []):
        groups.setdefault(edits, []).append((label, layout))
    return list(groups.items())


def _c_entries3d(entry, real, layouts):
    """``extern "C" int <entry>_<f32|f64>(int v, ...)``: the kernel laid out
    as ``layouts[v]``."""
    chord, comp = ENTRIES3D[entry]
    nptr = ENTRY_ARGS[entry][1]
    params = ", ".join([f"{real}* p{i}" for i in range(nptr)]
                       + ["long long n", f"const {real}* c", "int max_iters"])
    ptrs = [f"p{i}" for i in range(nptr)]
    if not comp:
        ptrs.insert(4, "nullptr")  # no ehat channels
    args = ", ".join(ptrs + ["n", "c", "max_iters"])
    cases = "".join(
        f"    case {v}: return host_layout<{real}, {str(chord).lower()}, {str(comp).lower()}, "
        f"{layout}>({args});\n" for v, (_, layout) in enumerate(layouts))
    sfx = "f32" if real == "float" else "f64"
    return (f'extern "C" int {entry}_{sfx}(int v, {params}) {{\n  switch (v) {{\n{cases}  }}\n'
            f"  return 1;\n}}\n")


def _bind(lib):
    for entry, (lead, nptr) in ENTRY_ARGS.items():
        for suffix, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
            fn = getattr(lib, f"{entry}_{suffix}", None)
            if fn is None:
                continue
            tail = [ctypes.c_longlong, ctypes.POINTER(real)]
            if entry != "host_be2d":
                tail.append(ctypes.c_int)
            fn.argtypes = [ctypes.c_int] * bool(lead) + [ctypes.c_void_p] * nptr + tail


def _host_source(src):
    """A CUDA source as host code: its launches made plain calls, its
    dynamic shared memory a static array."""
    src = re.sub(r"<<<.*?>>>", "", src, flags=re.S)
    return re.sub(r"extern __shared__ (.*?)\[\];", r"static \1[1 << 18];", src)


def _kernels_only(src):
    """A source cut after its anonymous namespace: its kernels without the
    C entries, which would build every kernel."""
    return src[:src.index("}  // namespace\n") + len("}  // namespace\n")]


# K3 in a unit's layout of the variant timer (host_be2d's code 3)
LAYOUT_CALL = """{
    using D = k3layout::Layout<R>;
    return host_blocks<D::kThreads, D::kE>(
        n, [=] { k3layout::hess2d_kernel<R, D>(z, cells, out, n, k); });
  }"""


def unit_be2d(label):
    """The host library of K3 in the layout ``label`` of
    ``scripts/cuda_k3_variants.py``."""
    return f"be2d {label}"


def elements(layout):
    """Elements a block of a K3 layout, ``HessLayout<threads, G, ...>``."""
    threads, g = (int(v) for v in re.match(r"HessLayout<(\d+), (\d+),", layout).groups())
    return threads // 32 * (32 // g)


def k3_elements(lib, f64):
    """Elements a block of K3 as shipped, from the host library's
    ``mm_hess2d_block``."""
    shape = (ctypes.c_int * 2)()
    lib.mm_hess2d_block(int(f64), shape)
    return shape[0]


def be2d_runs(f64, lib):
    """``[(library, code, label, elements)]`` of the K2 and K3 runs: K2, K3
    as shipped (``lib`` the host library that has it), the six-pass K3, then
    K3 in every layout of the variant timer (``elements`` a block, None
    where the kernel is one thread an element of 128 with no block of its
    own)."""
    return ([("be2d", 0, "K2 eg2d", None),
             ("be2d", 1, "K3 hess2d as shipped", k3_elements(lib, f64)),
             ("be2d", 2, "K3 hess2d, " + K3V.PARENT, None)]
            + [(unit_be2d(label), 3, f"K3 hess2d, {label}", elements(K3V.LAYOUTS[label][f64]))
               for label in K3V.LAYOUTS])


def unit3d(entry, real, i):
    """The host library of a 3D entry's ``i``-th group of variants."""
    return f"prox3d {entry} {real} {i}"


def build(tmp: str, only) -> dict:
    """The host libraries of the sources in ``only``, compiled together:
    prox2d one; be2d one for K2, K3 as shipped and the six-pass K3, and one
    per K3 layout of the variant timer (``unit_be2d``); prox3d one per 3D
    entry, real type and text edits of its variants (``unit3d``), each with
    its kernels only."""
    with open(os.path.join(tmp, "cuda_runtime.h"), "w") as f:
        f.write(STUB)
    for name in os.listdir(CSRC):
        with open(os.path.join(CSRC, name)) as f:
            src = f.read()
        with open(os.path.join(tmp, name), "w") as f:
            f.write(src)
    units = {}
    for name, entries in HOST_ENTRIES.items():
        if name not in only:
            continue
        with open(os.path.join(CSRC, f"{name}.cu")) as f:
            src = f.read()
        if name == "prox2d":  # K1's group design, which the variant timer builds
            src = src.replace(K1V.LAUNCH, K1V.GROUP_HELPERS + K1V.GROUP_KERNEL + K1V.LAUNCH)
        if name == "be2d":  # K2, K3 as shipped, the six-pass K3 and every layout
            parent = (entries.replace("PARENT_CALL", "hess2d_parent_kernel<R>(z, cells, out, n, k)")
                      .replace("LAYOUT_CALL", "return 1"))
            units[name] = _host_source(K3V.with_parent(src)) + parent + _c_entries(name)
            laid_out = (entries.replace("PARENT_CALL", "return 1")
                        .replace("LAYOUT_CALL", LAYOUT_CALL))
            for label, (f, d) in K3V.LAYOUTS.items():
                units[unit_be2d(label)] = (
                    _host_source(K3V.with_layouts(src, f, d)) + laid_out + _c_entries(name))
            continue
        if name != "prox3d":
            units[name] = _host_source(src) + entries + _c_entries(name)
            continue
        for e in ENTRIES3D:
            for real in ("float", "double"):
                for i, (edits, layouts) in enumerate(variants3d(e, real)):
                    units[unit3d(e, real, i)] = (
                        _host_source(_kernels_only(K4V.apply_edits(src, edits))) + entries
                        + _c_entries3d(e, real, layouts))
    jobs = []
    for i, (name, text) in enumerate(units.items()):
        cpp, so = os.path.join(tmp, f"unit{i}.cpp"), os.path.join(tmp, f"libunit{i}.so")
        with open(cpp, "w") as f:
            f.write(text)
        jobs.append((name, so, subprocess.Popen(
            ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fno-fast-math", "-shared",
             "-fPIC", "-pthread", "-w", "-I", tmp, cpp, "-o", so])))
    libs = {}
    for name, so, proc in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"g++ failed on {so} ({name})")
        libs[name] = ctypes.CDLL(so)
        _bind(libs[name])
    return libs


def correctly_rounded_sqrt(x):
    """A correctly rounded square root: f32 through f64; f64 through NumPy
    (the hardware's IEEE square root)."""
    if isinstance(x, N.Dual):
        s = correctly_rounded_sqrt(x.v)
        return N.Dual(s, x.d * (0.5 / s))
    if x.dtype == torch.float64:
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x.double()).float()


# (configuration, prox_chord) of each run; the float64 ones take the
# float64 builds
_COMP64 = dict(test_type="SquareGrid", dim=3, mon_type=5, nx=4, ny=4, nz=4, comp_mesh=True,
               rho=10.0, dtype="float64", prox_backend="pallas")
CASES = [
    (dict(test_type="Shoulder", dim=2, mon_type=1, nx=16, ny=16), None),
    (dict(test_type="SquareGrid", dim=3, mon_type=1, nx=4, ny=4, nz=4), None),
    (dict(test_type="Shoulder", dim=3, mon_type=0, nx=4, ny=4, nz=4), None),
    (dict(test_type="SquareGrid", dim=3, mon_type=1, nx=6, ny=6, nz=6), None),
    (dict(test_type="SquareGrid", dim=3, mon_type=5, nx=4, ny=4, nz=4, comp_mesh=True,
          rho=10.0), True),
    (dict(test_type="SquareGrid", dim=3, mon_type=5, nx=6, ny=6, nz=6, comp_mesh=True,
          rho=10.0), True),
    (dict(test_type="SquareGrid", dim=3, mon_type=1, nx=4, ny=4, nz=4), True),
    (dict(test_type="SquareGrid", dim=3, mon_type=5, nx=4, ny=4, nz=4, comp_mesh=True,
          rho=10.0), False),
    (dict(test_type="Shoulder", dim=2, mon_type=1, nx=16, ny=16, dtype="float64"), None),
    (dict(test_type="SquareGrid", dim=3, mon_type=1, nx=4, ny=4, nz=4, dtype="float64"), None),
    (dict(test_type="Shoulder", dim=3, mon_type=0, nx=4, ny=4, nz=4, dtype="float64"), None),
    (dict(test_type="SquareGrid", dim=3, mon_type=1, nx=6, ny=6, nz=6, dtype="float64"), None),
    (_COMP64, True),
    (dict(_COMP64, nx=6, ny=6, nz=6), True),
    (dict(test_type="SquareGrid", dim=3, mon_type=1, nx=4, ny=4, nz=4, dtype="float64",
          prox_backend="pallas"), True),
    (_COMP64, False),
]


def shipped_elements(entry):
    """Elements a block of the shipped float64 layout of a 3D entry."""
    alias = {"host_prox3d": "K4Double", "host_prox3d_chord_comp": "K4ChordCompDouble",
             "host_prox3d_comp": "K4CompDouble", "host_prox3d_chord": "K4ChordDouble"}[entry]
    with open(os.path.join(CSRC, "prox3d.cu")) as f:
        threads, lanes = re.search(r"using %s = Layout<(\d+), (\d+)," % alias, f.read()).groups()
    return int(threads) // int(lanes)


def runs_of(entry, dtype, max_iters):
    """``[(library, variant, label, cut, max_iters)]`` of an entry: K1 as
    shipped and its group designs (``K1_RUNS``), a 3D kernel in every
    variant of ``variants3d``, each on all the inputs; then as shipped on
    the first 1, 30 and 131 columns; in float64 also on kE -
    1 and kE + 1 columns (kE its elements a block), on a block of carved
    slots and with ``max_iters`` 1."""
    if entry == "host_prox2d":
        runs = [("prox2d", g, "as shipped" if g == 0 else
                 f"{g // 100} lanes per element, {g // 10 % 10} Hessian columns a pass, "
                 f"{g % 10} passes unrolled", None, max_iters) for g in K1_RUNS]
        return runs + [("prox2d", 0, "as shipped", m, max_iters) for m in (1, 30, 131)]
    real = "double" if dtype == torch.float64 else "float"
    runs = [(unit3d(entry, real, i), v, label, None, max_iters)
            for i, (_, layouts) in enumerate(variants3d(entry, real))
            for v, (label, _) in enumerate(layouts)]
    shipped = unit3d(entry, real, 0)
    runs += [(shipped, 0, "as shipped", m, max_iters) for m in (1, 30, 131)]
    if (entry, real) in TIMED64:
        e = shipped_elements(entry)
        runs += [(shipped, 0, "as shipped", m, max_iters) for m in (e - 1, e + 1)]
        runs += [(shipped, 0, "as shipped", "carved", max_iters),
                 (shipped, 0, "as shipped", None, 1)]
    return runs


def _report(label, kw, m, same):
    print(f"{label} at {kw['test_type']} {kw['dim']}D nx={kw['nx']} {kw['dtype']}, {m} slots: "
          f"host kernel bit-equal to the plain version on {100 * same:.2f} % of elements",
          flush=True)


def main() -> int:
    only = set(sys.argv[1:]) or set(HOST_ENTRIES)
    if not only <= set(HOST_ENTRIES):
        print(f"sources are {sorted(HOST_ENTRIES)}, not {sorted(only - set(HOST_ENTRIES))}",
              file=sys.stderr)
        return 2
    a = torch.tensor(np.random.default_rng(0).uniform(0.01, 10.0, 1_000_003).astype(np.float32))
    differ = float((torch.sqrt(a) != correctly_rounded_sqrt(a)).float().mean())
    print(f"PyTorch CPU sqrt differs from the correctly rounded f32 sqrt on {100 * differ:.2f} % "
          f"of 1,000,003 uniform inputs", flush=True)
    a = a.double() * (1.0 + 1e-9)
    differ = float((torch.sqrt(a) != correctly_rounded_sqrt(a)).float().mean())
    print(f"... and from the correctly rounded f64 sqrt on {100 * differ:.2f} %", flush=True)
    P2.sqrt = P3.sqrt = correctly_rounded_sqrt
    rng = np.random.default_rng(0)
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, only)
        for kw, chord in CASES:
            kw = dict(dict(method=0, dt=5e-3, tau=0.1, rho=50.0, dtype="float32"), **kw)
            runs_prox = ("prox2d" if kw["dim"] == 2 and chord is None else "prox3d") in only
            if not (runs_prox or (kw["dim"] == 2 and "be2d" in only)):
                continue
            dtype = getattr(torch, kw["dtype"])
            sfx, real = (("_f64", ctypes.c_double) if dtype == torch.float64
                         else ("_f32", ctypes.c_float))
            _, integ = build_problem(ExperimentConfig(**kw), device="cpu", prox_chord=chord)
            _, x, z, u = integ.start(integ.init_state())
            noise = torch.tensor(rng.normal(scale=3e-3, size=tuple(u.shape)), dtype=dtype)
            dxpu = integ.gather(x) + u + noise
            ehat = [float(v) for v in integ.mesh.ehat_np.reshape(-1)]
            consts = [*N.consts(integ.w, dtype), N.rnd(integ.prox_tol, dtype)]
            k3 = list(P3._consts3(integ.w, integ.prox_tol, dtype))
            if chord is not None:  # the stock engine: element-major blocks to channels
                nf = z.shape[0]
                name = "prox3d"
                args = tuple(a.reshape(nf, 12).T.contiguous() for a in (z, dxpu, integ.free))
                args += (element_cell_rows(integ.mesh.grid, z),)
                if kw.get("comp_mesh"):
                    entry, plain = (("host_prox3d_chord_comp", P3.prox3d_chord_comp_plain)
                                    if chord else ("host_prox3d_comp", P3.prox3d_comp_plain))
                    args += (integ.mesh.elem_ehat.reshape(nf, 9).T.contiguous(),)
                    k, pargs = k3, ()
                else:
                    entry, plain = "host_prox3d_chord", P3.prox3d_chord_plain
                    k, pargs = [*ehat, *k3], (ehat,)
            elif kw["dim"] == 2:
                name, entry, plain = "prox2d", "host_prox2d", P2.prox2d_plain
                args = (z.contiguous(), dxpu.contiguous(), integ.free, integ.cells(z))
                k = [*ehat, *consts]
                pargs = (ehat,)
            else:
                name, entry, plain = "prox3d", "host_prox3d", P3.prox3d_plain
                args = (z.contiguous(), dxpu.contiguous(), integ.free, integ.cells(z))
                k = [*ehat, *k3]
                pargs = (ehat,)
            n = args[0].shape[1]
            plains = {}  # the plain version's outputs by (cut, max_iters)
            for lib, v, label, cut, iters in (runs_of(entry, dtype, integ.prox_max_iters)
                                              if runs_prox else ()):
                a_m = args
                if cut == "carved":  # a block of slots whose free mask is all 0
                    carved = torch.nonzero(args[2].sum(0) == 0)[:, 0]
                    e = shipped_elements(entry)
                    cols = carved[:e] if carved.numel() >= e else torch.arange(e)
                    a_m = tuple(a[:, cols].contiguous() for a in args)
                    a_m = a_m[:2] + (torch.zeros_like(a_m[2]),) + a_m[3:]
                elif cut is not None:
                    a_m = tuple(a[:, :cut].contiguous() for a in args)
                m = a_m[0].shape[1]
                if (cut, iters) not in plains:
                    plains[cut, iters] = plain(*a_m, *pargs, integ.w, integ.prox_tol, iters)
                zp, ihp = plains[cut, iters]
                zo, ih = torch.empty_like(a_m[0]), torch.empty(m, dtype=dtype)
                getattr(libs[lib], entry + sfx)(
                    v, *[t.data_ptr() for t in (*a_m, zo, ih)], m, (real * len(k))(*k), iters)
                same = float(((zo == zp).all(0) & (ih == ihp)).float().mean())
                failed += same < 1.0
                _report(entry[5:] + f", {label}" + (
                    " (computational mesh)" if kw.get("comp_mesh") else "") + (
                    ", a block of carved slots" if cut == "carved" else
                    f", first {m} columns" if cut else "") + (
                    f", max_iters {iters}" if iters != integ.prox_max_iters else ""), kw, m, same)
            if kw["dim"] == 2 and "be2d" in only:  # K2, K3 and K3 at its block's edges
                zb = z.contiguous()
                cb = integ.cells(zb)
                for lib, code, label, e in be2d_runs(dtype == torch.float64, libs["be2d"]):
                    cuts = [None] + ([] if e is None else sorted({1, e - 1, e, e + 1}))
                    for cut in cuts:
                        m = n if cut is None else cut
                        zc, cc = zb[:, :m].contiguous(), cb[:, :m].contiguous()
                        out = torch.empty((7 if code == 0 else 21, m), dtype=dtype)
                        getattr(libs[lib], "host_be2d" + sfx)(
                            code, zc.data_ptr(), cc.data_ptr(), out.data_ptr(), m,
                            (real * 4)(*ehat))
                        if code == 0:
                            ref = B.eg2d_plain(zc, cc, ehat)
                            ref = torch.cat([ref[0], ref[1][None]])
                        else:
                            ref = B.hess2d_plain(zc, cc, ehat)
                        same = float((out == ref).all(0).float().mean())
                        failed += same < 1.0
                        cols = "" if cut is None else f", first {m} columns"
                        _report(f"be2d {label}{cols}", kw, m, same)
    print(f"{failed} runs not bit-equal", flush=True)
    return int(failed > 0)


if __name__ == "__main__":
    sys.exit(main())
