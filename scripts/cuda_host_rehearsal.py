"""Run kernels K1-K4, K4' and K4'' as host code against their plain
PyTorch versions, in float32 and in float64, as the card builds them: a
rehearsal of their arithmetic where there is no card and no ``nvcc``.

    python scripts/cuda_host_rehearsal.py

Compiles ``mmadmm_tpu_torch/csrc/prox2d.cu``, ``be2d.cu`` and
``prox3d.cu`` with ``g++ -ffp-contract=off`` (no fused multiply-add, as
``nvcc --fmad=false``) against a stub ``cuda_runtime.h`` that defines
``__device__``, ``__ldg``, ``threadIdx`` and the like as host code, into a
temporary directory, each kernel through one ``extern "C"`` entry per real
type. The one-thread-per-element kernels K2 and K3 are called once per
element, one after another. The kernels where a group of lanes shares an
element run a block at a time with one host thread per lane
(``threadIdx`` is thread-local), ``__syncthreads``, ``__syncwarp`` and
``__ballot_sync`` being host barriers over the block or the mask's lanes:
K1 as shipped (one thread an element, 64 a block) and the group design
that ``scripts/cuda_k1_variants.py`` builds beside it (``GROUP_KERNEL``
there) with 1, 2, 3 and 6 lanes per element and one Hessian column a dual
pass, with 2, 3 and 6 columns a pass at 1 lane, 3 at 2 lanes and 2 at 3
lanes, and with 2, 3 and 6 passes unrolled together at 1 lane and 3 at 2
lanes, the Newton kernels K4 and K4''b
with 4, 8 and 16, the chord kernels K4' and K4''a with 2, 4 and 8; each
also on the first 1, 30 and 131 columns of its inputs as its source
launches it (K1 as shipped; 4 and 2 lanes for the 3D kernels; the block's
copies then take the one-value
path). Their outputs
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

from mmadmm_tpu_torch import ExperimentConfig, build_problem  # noqa: E402
from mmadmm_tpu_torch.cuda_build import CSRC  # noqa: E402
from mmadmm_tpu_torch.ops.monitor_grid import element_cell_rows  # noqa: E402
from mmadmm_tpu_torch.ops import be2d as B  # noqa: E402
from mmadmm_tpu_torch.ops import newton as N  # noqa: E402
from mmadmm_tpu_torch.ops import prox2d as P2  # noqa: E402
from mmadmm_tpu_torch.ops import prox3d as P3  # noqa: E402

STUB = """#pragma once
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>
#define __device__
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
// K2 (hess 0) or K3 (hess 1): out is g [6, n] then ih [n], or H [21, n]
template <typename R>
int host_be2d(int hess, const R* z, const R* cells, R* out, long long n, const R* c) {
  Consts<R> k{c[0], c[1], c[2], c[3], R(0), R(0), R(0), R(0)};
  blockDim.x = 128;
  for (long long e = 0; e < n; ++e) {
    blockIdx.x = e / 128; threadIdx.x = e % 128;
    if (hess)
      hess2d_kernel<R>(z, cells, out, n, k);
    else
      eg2d_kernel<R>(z, cells, out, out + 6 * n, n, k);
  }
  return 0;
}
""",
    "prox3d": """
#include <thread>
#include <vector>

// the chord kernels (K4', K4''a) with G lanes per element: a block of
// kChordE<R> elements at a time, one host thread per lane
template <typename R, bool kComp, int G>
int host_chord(const R* z, const R* dxpu, const R* fr, const R* cells, const R* ehat, R* zout,
               R* ih0, long long n, const R* c, int max_iters) {
  Ehat3<R> eh{};
  Consts3<R> k;
  if (!kComp) std::memcpy(&eh, c, sizeof(eh));
  std::memcpy(&k, c + (kComp ? 0 : 9), sizeof(k));
  constexpr int kE = kChordE<R>;
  blockDim.x = kE * G;
  for (long long b = 0; b * kE < n; ++b) {
    blockIdx.x = b;
    std::vector<std::thread> lanes;
    for (unsigned t = 0; t < (unsigned)(kE * G); ++t)
      lanes.emplace_back([=] {
        threadIdx.x = t;
        prox3d_chord_kernel<R, kComp, G>(z, dxpu, fr, cells, ehat, zout, ih0, n, eh, k,
                                         max_iters);
      });
    for (auto& l : lanes) l.join();
  }
  return 0;
}

template <typename R, bool kComp>
int host_chord_g(int g, const R* z, const R* dxpu, const R* fr, const R* cells, const R* ehat,
                 R* zout, R* ih0, long long n, const R* c, int max_iters) {
  switch (g) {
    case 2: return host_chord<R, kComp, 2>(z, dxpu, fr, cells, ehat, zout, ih0, n, c, max_iters);
    case 4: return host_chord<R, kComp, 4>(z, dxpu, fr, cells, ehat, zout, ih0, n, c, max_iters);
    case 8: return host_chord<R, kComp, 8>(z, dxpu, fr, cells, ehat, zout, ih0, n, c, max_iters);
  }
  return 1;
}

// the Newton kernels (K4, K4''b) with G lanes per element: a block at a
// time, one host thread per lane, the barriers and ballots as above
template <typename R, bool kComp, int G>
int host_newton(const R* z, const R* dxpu, const R* fr, const R* cells, const R* ehat, R* zout,
                R* ih0, long long n, const R* c, int max_iters) {
  Ehat3<R> eh{};
  Consts3<R> k;
  if (!kComp) std::memcpy(&eh, c, sizeof(eh));
  std::memcpy(&k, c + (kComp ? 0 : 9), sizeof(k));
  constexpr int kT = kNewtonThreads<R>;
  blockDim.x = kT;
  const long long per_block = kT / G;
  for (long long b = 0; b * per_block < n; ++b) {
    blockIdx.x = b;
    std::vector<std::thread> lanes;
    for (unsigned t = 0; t < (unsigned)kT; ++t)
      lanes.emplace_back([=] {
        threadIdx.x = t;
        prox3d_newton_kernel<R, kComp, G>(z, dxpu, fr, cells, ehat, zout, ih0, n, eh, k,
                                          max_iters);
      });
    for (auto& l : lanes) l.join();
  }
  return 0;
}

template <typename R, bool kComp>
int host_newton_g(int g, const R* z, const R* dxpu, const R* fr, const R* cells, const R* ehat,
                  R* zout, R* ih0, long long n, const R* c, int max_iters) {
  switch (g) {
    case 4: return host_newton<R, kComp, 4>(z, dxpu, fr, cells, ehat, zout, ih0, n, c, max_iters);
    case 8: return host_newton<R, kComp, 8>(z, dxpu, fr, cells, ehat, zout, ih0, n, c, max_iters);
    case 16: return host_newton<R, kComp, 16>(z, dxpu, fr, cells, ehat, zout, ih0, n, c, max_iters);
  }
  return 1;
}

template <typename R>
int host_prox3d(int g, const R* z, const R* dxpu, const R* fr, const R* cells, R* zout, R* ih0,
                long long n, const R* c, int max_iters) {
  return host_newton_g<R, false>(g, z, dxpu, fr, cells, nullptr, zout, ih0, n, c, max_iters);
}

template <typename R>
int host_prox3d_chord(int g, const R* z, const R* dxpu, const R* fr, const R* cells, R* zout,
                      R* ih0, long long n, const R* c, int max_iters) {
  return host_chord_g<R, false>(g, z, dxpu, fr, cells, nullptr, zout, ih0, n, c, max_iters);
}

template <typename R>
int host_prox3d_chord_comp(int g, const R* z, const R* dxpu, const R* fr, const R* cells,
                           const R* ehat, R* zout, R* ih0, long long n, const R* c,
                           int max_iters) {
  return host_chord_g<R, true>(g, z, dxpu, fr, cells, ehat, zout, ih0, n, c, max_iters);
}

template <typename R>
int host_prox3d_comp(int g, const R* z, const R* dxpu, const R* fr, const R* cells,
                     const R* ehat, R* zout, R* ih0, long long n, const R* c, int max_iters) {
  return host_newton_g<R, true>(g, z, dxpu, fr, cells, ehat, zout, ih0, n, c, max_iters);
}
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


# lanes per element that the group entries are run with
# (K1: 0 as shipped, else 100 x lanes an element + 10 x Hessian columns a
# dual pass + passes unrolled together)
GROUPS = {"host_prox2d": (0, 111, 211, 311, 611, 121, 131, 161, 231, 321, 112, 113, 116, 213,
                          123),
          "host_prox3d": (4, 8, 16),
          "host_prox3d_comp": (4, 8, 16),
          "host_prox3d_chord": (2, 4, 8), "host_prox3d_chord_comp": (2, 4, 8)}


def build(tmp: str) -> dict:
    with open(os.path.join(tmp, "cuda_runtime.h"), "w") as f:
        f.write(STUB)
    for name in os.listdir(CSRC):
        with open(os.path.join(CSRC, name)) as f:
            src = f.read()
        with open(os.path.join(tmp, name), "w") as f:
            f.write(src)
    libs = {}
    for name, entries in HOST_ENTRIES.items():
        with open(os.path.join(CSRC, f"{name}.cu")) as f:
            src = f.read()
        if name == "prox2d":  # K1's group design, which the variant timer builds
            src = src.replace(K1V.LAUNCH, K1V.GROUP_HELPERS + K1V.GROUP_KERNEL + K1V.LAUNCH)
        src = re.sub(r"<<<[^>]*>>>", "", src) + entries + _c_entries(name)
        cpp, so = os.path.join(tmp, f"{name}.cpp"), os.path.join(tmp, f"lib{name}.so")
        with open(cpp, "w") as f:
            f.write(src)
        subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fno-fast-math",
                        "-shared", "-fPIC", "-pthread", "-w", "-I", tmp, cpp, "-o", so],
                       check=True)
        lib = ctypes.CDLL(so)
        for entry, (lead, nptr) in ENTRY_ARGS.items():
            for suffix, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
                fn = getattr(lib, f"{entry}_{suffix}", None)
                if fn is None:
                    continue
                tail = [ctypes.c_longlong, ctypes.POINTER(real)]
                if entry != "host_be2d":
                    tail.append(ctypes.c_int)
                fn.argtypes = [ctypes.c_int] * bool(lead) + [ctypes.c_void_p] * nptr + tail
        libs[name] = lib
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


def _report(label, kw, m, same):
    print(f"{label} at {kw['test_type']} {kw['dim']}D nx={kw['nx']} {kw['dtype']}, {m} slots: "
          f"host kernel bit-equal to the plain version on {100 * same:.2f} % of elements",
          flush=True)


def main() -> int:
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
        libs = build(tmp)
        for kw, chord in CASES:
            kw = dict(dict(method=0, dt=5e-3, tau=0.1, rho=50.0, dtype="float32"), **kw)
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
            zp, ihp = plain(*args, *pargs, integ.w, integ.prox_tol, integ.prox_max_iters)
            runs = [(g,) for g in GROUPS.get(entry, (None,))]
            shipped = 2 if entry in ("host_prox3d_chord", "host_prox3d_chord_comp") else 4
            if entry == "host_prox2d":  # K1 as shipped
                shipped = 0
            runs += [(shipped, m) for m in ((1, 30, 131) if entry in GROUPS else ())]
            for g, *cut in runs:
                m = cut[0] if cut else n
                a_m = tuple(a[:, :m].contiguous() for a in args)
                if cut:
                    zp, ihp = plain(*a_m, *pargs, integ.w, integ.prox_tol, integ.prox_max_iters)
                zo, ih = torch.empty_like(a_m[0]), torch.empty(m, dtype=dtype)
                getattr(libs[name], entry + sfx)(
                    *(() if g is None else (g,)), *[t.data_ptr() for t in (*a_m, zo, ih)], m,
                    (real * len(k))(*k), integ.prox_max_iters)
                same = float(((zo == zp).all(0) & (ih == ihp)).float().mean())
                failed += same < 1.0
                lanes = ((", as shipped" if g == 0 else
                          f", {g // 100} lanes per element, {g // 10 % 10} Hessian columns a "
                          f"pass, {g % 10} passes unrolled")
                         if entry == "host_prox2d" else f", {g} lanes per element" if g else "")
                _report(entry[5:] + lanes + (
                    " (computational mesh)" if kw.get("comp_mesh") else "") + (
                    f", first {m} columns" if cut else ""), kw, m, same)
            if kw["dim"] == 2:  # K2 and K3 on the same slots
                zb = z.contiguous()
                cb = integ.cells(zb)
                for hess, plain_be, rows in ((0, B.eg2d_plain, 7), (1, B.hess2d_plain, 21)):
                    out = torch.empty((rows, n), dtype=dtype)
                    getattr(libs["be2d"], "host_be2d" + sfx)(
                        hess, zb.data_ptr(), cb.data_ptr(), out.data_ptr(), n, (real * 4)(*ehat))
                    ref = plain_be(zb, cb, ehat)
                    ref = torch.cat([ref[0], ref[1][None]]) if hess == 0 else ref
                    same = float((out == ref).all(0).float().mean())
                    failed += same < 1.0
                    _report("be2d " + ("K3 hess2d" if hess else "K2 eg2d"), kw, n, same)
    print(f"{failed} runs not bit-equal", flush=True)
    return int(failed > 0)


if __name__ == "__main__":
    sys.exit(main())
