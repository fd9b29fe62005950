"""The 3D prox kernels of ``csrc/prox3d.cu`` against their
one-thread-per-element designs and against variants of their group
design, timed on the card.

    python3 scripts/cuda_k4_variants.py [newton] [chord] [newton64] [chord64]

``newton`` times the Newton-sweep kernels K4 and K4''b, ``chord`` the
chord-sweep kernels K4' and K4''a, ``newton64`` K4's float64 build,
``chord64`` the float64 builds of K4' and K4''a; with no argument, all
four. Builds, by plain
``nvcc`` into the git-ignored ``mmadmm_tpu_torch/_build/k4_variants/``,
copies of ``csrc/``, all started together:

- ``thread``: ``prox3d.cu`` with two one-thread-per-element kernels added,
  each thread sweeping its element alone, its inputs read from device
  memory where they are used, its Hessian triangle in shared memory
  [78][128]: the Newton sweep ``prox3d_thread_kernel<kComp, kLate>``
  (with ``kLate`` it retires on the gradient after computing its step, the
  JAX order, else before the Hessian) and the chord sweep
  ``prox3d_chord_thread_kernel<kComp>`` (the design K4' and K4''a had
  before their group design: the entry Hessian and ih0's energy first,
  each sweep retiring before its cached solve). The script generates this
  copy, so the designs the group kernels replaced can be timed beside them
  on the same card;
- ``as it is``: ``prox3d.cu`` unchanged;
- Newton variants: ``kGroup`` set to 4, 8 or 16 lanes per element and no
  minimum of blocks an SM in the Newton kernels' ``__launch_bounds__`` (up
  to 255 registers), and at G = 4 also a minimum of 3 and of 4 blocks of
  128 threads an SM (at most 168 and 128 registers);
- chord variants: ``kChordGroup`` set to 1, 2, 4 or 8 lanes per element (a
  block of 32 elements: 32, 64, 128 or 256 threads; 1 lane is the staged
  design without a group) with no minimum of blocks an SM; at G = 2 a
  minimum of 5 and of 6 blocks of 64 threads (at most 204 and 168
  registers), at G = 4 of 3 blocks of 128 (168); at G = 2 and 4 the
  factor in every lane's registers, one lane writing it back, instead of
  on one lane in place; at G = 2 and 4 the dual pass (``hess_col``) as a
  function of its own (``__noinline__``); at G = 2 the sweep loop kept
  rolled (``#pragma unroll 1``); and at G = 2, without a cap and with 6
  blocks an SM, the solve with the cached factors (``cached_direction``)
  inlined;
- float64 variants of K4 (``newton64``): 8 and 16 lanes per element in
  blocks of 64 threads (8 and 4 elements), and 32 elements a block of 128
  threads at 4 lanes, whose 84.5 KB stage is dynamic shared memory (set
  with ``cudaFuncSetAttribute``, at least 2 blocks an SM), against the
  shipped 16 elements of static shared memory;
- float64 variants of K4' and K4''a (``chord64``): 4 lanes per element
  at the shipped 16 elements a block (64 threads), against the shipped 2
  lanes (a block of one warp).

It prints each build's ``-Xptxas -v`` registers, stack, spills and shared
bytes for the selected kernels, then times every variant (median of 20
launches, CUDA events) in turns forward and back, and holds every variant
bit for bit to the plain version, on:

- K4 at the step-0 prox inputs of 3D Shoulder-40 (768,000 tet slots) and
  K4''b at those of 3D CompSquare-40 with ``prox_chord=False`` (768,000
  tets), against ``prox3d_plain`` and ``prox3d_comp_plain``;
- K4' at the stock engine's step-0 inputs of 3D CompSquare-40 (768,000
  tets) and CompSquare-20 (96,000), and K4''a at those of 3D
  SquareGrid-40 with ``prox_chord=True`` (768,000), against
  ``prox3d_chord_comp_plain`` and ``prox3d_chord_plain``;
- K4's float64 build at the step-0 prox inputs of 3D Shoulder-40 and 3D
  SquareGrid-40 in float64, against ``prox3d_plain`` in float64;
- the float64 K4' and K4''a at the stock engine's step-0 inputs of 3D
  CompSquare-40 and SquareGrid-40 (``prox_chord=True``) in float64 on the
  kernel route, against ``prox3d_chord_comp_plain`` and
  ``prox3d_chord_plain`` in float64.

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

import chip_smoke as C  # noqa: E402
from mmadmm_tpu_torch import cuda_build  # noqa: E402
from mmadmm_tpu_torch.ops import prox3d as P3  # noqa: E402

OUT = os.path.join(cuda_build.BUILD_DIR, "k4_variants")
LAUNCH = "template <typename R, bool kChord, bool kComp>\nint launch("

# The one-thread-per-element designs, on prox3d.cu's helpers: the Newton
# sweep with the retire test after the step (kLate, the JAX order) or
# before the Hessian, and the chord sweep as K4' and K4''a had it.
THREAD_KERNELS = r"""
// One element's 216 cell channels, channel-major with stride n, read from
// device memory where they are used.
struct Cells {
  const float* p;  // cells + element
  long long n;
  __device__ __forceinline__ float operator()(int c) const { return __ldg(p + c * n); }
};

// the lower triangle of the Hessian at z into H (this thread's column of
// the shared array, H[tri(i, j) * kThreads]), one dual pass per column
__device__ __forceinline__ void hess12(const float* z, const Cells& cells, const float* h,
                                       const float* dxpu, const float* fr, const Consts3<float>& k,
                                       const float* free_col, long long n, float* H) {
#pragma unroll 1
  for (int j = 0; j < 12; ++j)
    hess_col<kThreads>(j, z, cells, h, dxpu, fr, k, __ldg(free_col + j * n), H);
}

// backtracking: the largest accepted alpha, 0 if none
__device__ __forceinline__ float backtrack(const float* z, const float* p, const Cells& cells,
                                           const float* h, const float* dxpu, const Consts3<float>& k,
                                           float e0, float det_floor) {
  float alpha = 0.0f;
#pragma unroll 1
  for (int a = 0; a < 5; ++a)
    if (trial_ok(z, p, alpha_bt<float>(a), cells, h, dxpu, k, e0, det_floor)) alpha = alpha_bt<float>(a);
  return alpha;
}

// one element's inputs from device memory into registers
template <bool kComp>
__device__ __forceinline__ void load_thread(const float* z_in, const float* dxpu_in,
                                            const float* free_in, const float* ehat_in,
                                            long long n, long long e, float* z, float* dxpu,
                                            float* fr, float* h_e) {
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    z[c] = z_in[c * n + e];
    dxpu[c] = dxpu_in[c * n + e];
    fr[c] = free_in[c * n + e];
  }
  if constexpr (kComp) {
#pragma unroll
    for (int c = 0; c < 9; ++c) h_e[c] = ehat_in[c * n + e];
  }
}

template <bool kComp, bool kLate>
__global__ void __launch_bounds__(kThreads) prox3d_thread_kernel(
    const float* __restrict__ z_in, const float* __restrict__ dxpu_in,
    const float* __restrict__ free_in, const float* __restrict__ cells_in,
    const float* __restrict__ ehat_in, float* __restrict__ zout, float* __restrict__ ih0_out,
    long long n, Ehat3<float> eh, Consts3<float> k, int max_iters) {
  __shared__ float hess[kTri * kThreads];
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float* H = hess + threadIdx.x;
  const Cells cells{cells_in + e, n};
  float z[12], dxpu[12], fr[12], h_e[9];
  load_thread<kComp>(z_in, dxpu_in, free_in, ehat_in, n, e, z, dxpu, fr, h_e);
  const float* h = kComp ? h_e : eh.h;
  ih0_out[e] = energy3_unreg(z, cells, h, k);
  for (int it = 0; it < max_iters; ++it) {
    float g[12];
    float ih;
    float e0 = grad3<float>(z, cells, h, dxpu, fr, k, g, ih);
    float gnorm = norm1(g);
    if (!kLate && it > 0 && gnorm < k.tol) break;
    float p[12];
    hess12(z, cells, h, dxpu, fr, k, free_in + e, n, H);
    factor12<kThreads>(H);
    direction<kThreads>(H, g, k.inv_w2, p);
    float det_floor = floor_of(edet3(z));
    float alpha = backtrack(z, p, cells, h, dxpu, k, e0, det_floor);
    float step_inf = alpha * absmax(p);
    bool stalled = step_inf <= Num<float>::kEpsStall * (1.0f + absmax(z));
    if (kLate && it > 0 && gnorm < k.tol) break;
#pragma unroll
    for (int i = 0; i < 12; ++i) z[i] = z[i] + alpha * p[i];
    if (stalled) break;
  }
#pragma unroll
  for (int c = 0; c < 12; ++c) zout[c * n + e] = z[c];
}

template <bool kComp>
__global__ void __launch_bounds__(kThreads) prox3d_chord_thread_kernel(
    const float* __restrict__ z_in, const float* __restrict__ dxpu_in,
    const float* __restrict__ free_in, const float* __restrict__ cells_in,
    const float* __restrict__ ehat_in, float* __restrict__ zout, float* __restrict__ ih0_out,
    long long n, Ehat3<float> eh, Consts3<float> k, int max_iters) {
  __shared__ float hess[kTri * kThreads];
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float* H = hess + threadIdx.x;
  const Cells cells{cells_in + e, n};
  float z[12], dxpu[12], fr[12], h_e[9];
  load_thread<kComp>(z_in, dxpu_in, free_in, ehat_in, n, e, z, dxpu, fr, h_e);
  const float* h = kComp ? h_e : eh.h;
  ih0_out[e] = energy3_unreg(z, cells, h, k);
  hess12(z, cells, h, dxpu, fr, k, free_in + e, n, H);
  factor12<kThreads>(H);
  for (int it = 0; it < max_iters; ++it) {
    float g[12];
    float ih;
    float e0 = grad3<float>(z, cells, h, dxpu, fr, k, g, ih);
    if (it > 0 && norm1(g) < k.tol) break;
    float det_floor = floor_of(edet3(z));
    float p[12];
    direction<kThreads>(H, g, k.inv_w2, p);
    if (!trial_ok(z, p, 1.0f, cells, h, dxpu, k, e0, det_floor)) {
      hess12(z, cells, h, dxpu, fr, k, free_in + e, n, H);
      factor12<kThreads>(H);
      direction<kThreads>(H, g, k.inv_w2, p);
      float alpha = backtrack(z, p, cells, h, dxpu, k, e0, det_floor);
#pragma unroll
      for (int i = 0; i < 12; ++i) p[i] = alpha * p[i];
    }
    bool stalled = absmax(p) <= Num<float>::kEpsStall * (1.0f + absmax(z));
#pragma unroll
    for (int i = 0; i < 12; ++i) z[i] = z[i] + p[i];
    if (stalled) break;
  }
#pragma unroll
  for (int c = 0; c < 12; ++c) zout[c * n + e] = z[c];
}

// design 0: Newton, retire before the Hessian; 1: Newton, retire after the
// step; 2: chord
template <bool kComp>
int launch_thread(int design, const float* z, const float* dxpu, const float* free_,
                  const float* cells, const float* ehat, float* zout, float* ih0, long long n,
                  const float* consts, int max_iters) {
  if (n <= 0) return 0;
  Ehat3<float> eh{};
  Consts3<float> k;
  if constexpr (!kComp) std::memcpy(&eh, consts, sizeof(eh));
  std::memcpy(&k, consts + (kComp ? 0 : 9), sizeof(k));
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (design == 0)
    prox3d_thread_kernel<kComp, false><<<blocks, kThreads>>>(z, dxpu, free_, cells, ehat, zout,
                                                             ih0, n, eh, k, max_iters);
  else if (design == 1)
    prox3d_thread_kernel<kComp, true><<<blocks, kThreads>>>(z, dxpu, free_, cells, ehat, zout,
                                                            ih0, n, eh, k, max_iters);
  else
    prox3d_chord_thread_kernel<kComp><<<blocks, kThreads>>>(z, dxpu, free_, cells, ehat, zout,
                                                            ih0, n, eh, k, max_iters);
  return (int)cudaGetLastError();
}

"""

THREAD_ENTRY = r"""
extern "C" int mm_prox3d_thread(int design, const float* z, const float* dxpu, const float* fr,
                                const float* cells, const float* ehat, float* zout, float* ih0,
                                long long n, const float* consts, int max_iters) {
  return ehat == nullptr
             ? launch_thread<false>(design, z, dxpu, fr, cells, ehat, zout, ih0, n, consts,
                                    max_iters)
             : launch_thread<true>(design, z, dxpu, fr, cells, ehat, zout, ih0, n, consts,
                                   max_iters);
}
"""


def _sub(s, old, new):
    if old not in s:
        raise RuntimeError(f"prox3d.cu has no {old!r}, which this script edits")
    return s.replace(old, new)


NEWTON_BOUNDS = ("__launch_bounds__(kNewtonThreads<R>, kComp ? kBlocksComp : kBlocks) "
                 "prox3d_newton_kernel(")
CHORD_BOUNDS = "__launch_bounds__(kChordE<R> * G)\n    prox3d_chord_kernel("
CHORD_GROUPS = ('static_assert(G == 2 || G == 4 || G == 8, "a group is 2, 4 or 8 lanes of one '
                'warp");')
FACTOR = "  if (lane == 0) factor12<1>(H);\n"
# every lane factors a copy of the triangle in its registers, one writes it back
FACTOR_IN_REGISTERS = """  R L[kTri];
#pragma unroll
  for (int t = 0; t < kTri; ++t) L[t] = H[t];
  factor12<1>(L);
  __syncwarp(gmask);  // every lane has its copy before lane 0 writes
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < kTri; ++t) H[t] = L[t];
  }
"""


def _newton(g, blocks):
    """kGroup = g and ``__launch_bounds__(kNewtonThreads<R>, blocks)`` on the Newton
    kernels (no minimum where ``blocks`` is 0)."""
    def edit(s):
        bounds = f"(kNewtonThreads<R>, {blocks})" if blocks else "(kNewtonThreads<R>)"
        s = re.sub(r"constexpr int kGroup = \d+;", f"constexpr int kGroup = {g};", s)
        return _sub(s, NEWTON_BOUNDS, f"__launch_bounds__{bounds} prox3d_newton_kernel(")
    return edit


# the chord kernels' dual passes in a function of their own (its registers
# apart from the sweep's), their sweep loop kept rolled, and their solve
# with the cached factors inlined
NOINLINE = ("__device__ __forceinline__ void hess_col(", "__device__ __noinline__ void hess_col(")
INLINED = ("__device__ __noinline__ void cached_direction(",
           "__device__ __forceinline__ void cached_direction(")
ROLLED = ("if (max_iters <= 0 && lane == 0) ih0_out[e] = energy3_unreg(z, cells, h, k);\n",
          "if (max_iters <= 0 && lane == 0) ih0_out[e] = energy3_unreg(z, cells, h, k);\n"
          "#pragma unroll 1\n")


def _chord(g, blocks, factor_one_lane=True, *edits):
    """kChordGroup = g (1 lane allowed too), ``__launch_bounds__(32 g,
    blocks)`` on the chord kernels (no minimum where ``blocks`` is 0), the
    factor on one lane or in every lane's registers, then the ``(old,
    new)`` text edits."""
    def edit(s):
        for old, new in edits:
            s = _sub(s, old, new)
        s = re.sub(r"constexpr int kChordGroup = \d+;", f"constexpr int kChordGroup = {g};", s)
        s = _sub(s, CHORD_GROUPS, "static_assert(G == 1 || G == 2 || G == 4 || G == 8);")
        if blocks:
            s = _sub(s, CHORD_BOUNDS,
                     f"__launch_bounds__(kChordE<R> * G, {blocks})\n    prox3d_chord_kernel(")
        if not factor_one_lane:
            s = _sub(s, FACTOR, FACTOR_IN_REGISTERS)
        return s
    return edit


# K4's float64 stage of 32 elements in dynamic shared memory, in blocks of
# 128 threads; at 84.5 KB a stage an SM holds 2 such blocks
DYNAMIC_STAGE = (
    ("constexpr int kNewtonThreads = sizeof(R) == 4 ? 128 : 64;",
     "constexpr int kNewtonThreads = 128;"),
    ("  __shared__ __align__(16) NewtonStage<R, kComp, kE> st;",
     "  extern __shared__ __align__(16) unsigned char stage_bytes[];\n"
     "  NewtonStage<R, kComp, kE>& st = *reinterpret_cast<NewtonStage<R, kComp, kE>*>"
     "(stage_bytes);"),
    ("    prox3d_newton_kernel<R, kComp, kGroup><<<(unsigned)blocks, kT, 0, "
     "(cudaStream_t)stream>>>(",
     "    constexpr int kStage = (int)sizeof(NewtonStage<R, kComp, kE>);\n"
     "    cudaFuncSetAttribute(prox3d_newton_kernel<R, kComp, kGroup>,\n"
     "                         cudaFuncAttributeMaxDynamicSharedMemorySize, kStage);\n"
     "    prox3d_newton_kernel<R, kComp, kGroup><<<(unsigned)blocks, kT, kStage, "
     "(cudaStream_t)stream>>>("),
)


def _dynamic(s):
    for old, new in DYNAMIC_STAGE:
        s = _sub(s, old, new)
    return _newton(4, 2)(s)


BUILDS = {
    "thread": lambda s: _sub(s, LAUNCH, THREAD_KERNELS + LAUNCH) + THREAD_ENTRY,
    "as it is": lambda s: s,
}
NEWTON_BUILDS = {
    "Newton G=4, no block minimum": _newton(4, 0),
    "Newton G=4, 3 blocks an SM": _newton(4, 3),
    "Newton G=4, 4 blocks an SM": _newton(4, 4),
    "Newton G=8, no block minimum": _newton(8, 0),
    "Newton G=16, no block minimum": _newton(16, 0),
}
CHORD_BUILDS = {
    "chord G=1, no block minimum": _chord(1, 0),
    "chord G=2, no block minimum": _chord(2, 0),
    "chord G=2, 5 blocks an SM": _chord(2, 5),
    "chord G=2, 6 blocks an SM": _chord(2, 6),
    "chord G=2, no block minimum, factor in registers": _chord(2, 0, False),
    "chord G=4, no block minimum": _chord(4, 0),
    "chord G=4, 3 blocks an SM": _chord(4, 3),
    "chord G=4, no block minimum, factor in registers": _chord(4, 0, False),
    "chord G=8, no block minimum": _chord(8, 0),
    "chord G=2, no block minimum, dual pass not inlined": _chord(2, 0, True, NOINLINE),
    "chord G=4, no block minimum, dual pass not inlined": _chord(4, 0, True, NOINLINE),
    "chord G=2, no block minimum, sweep loop rolled": _chord(2, 0, True, ROLLED),
    "chord G=2, no block minimum, solve inlined": _chord(2, 0, True, INLINED),
    "chord G=2, 6 blocks an SM, solve inlined": _chord(2, 6, True, INLINED),
}
NEWTON64_BUILDS = {
    "float64 K4, G=8 (8 elements a block of 64)": _newton(8, 4),
    "float64 K4, G=16 (4 elements a block of 64)": _newton(16, 4),
    "float64 K4, 32 elements a block of 128, dynamic shared memory": _dynamic,
}
CHORD64_BUILDS = {
    "float64 K4' and K4''a, G=4 (16 elements a block of 64)": _chord(4, 0),
}
FAMILY_BUILDS = {"newton": NEWTON_BUILDS, "chord": CHORD_BUILDS, "newton64": NEWTON64_BUILDS,
                 "chord64": CHORD64_BUILDS}
# the family whose kernels' ptxas lines a family prints
PTXAS_FAMILY = {"newton": "newton", "chord": "chord", "newton64": "newton", "chord64": "chord"}
THREAD_NAMES = {
    "newton": {0: "one thread per element, retire before the Hessian",
               1: "one thread per element, retire after the step"},
    "chord": {2: "one thread per element (the design before the group)"},
}


def _ptxas(out: str, family: str):
    """``(kernel, registers, stack, spill stores, spill loads, shared
    bytes)`` of the ``family`` kernels in an ``nvcc -Xptxas -v`` log."""
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
        if family == "newton":
            t = re.search(r"prox3d_newton_kernelI([fd])Lb([01])ELi(\d+)E", name)
            u = re.search(r"prox3d_thread_kernelILb([01])ELb([01])E", name)
            if t:
                kernel = (("K4''b" if t.group(2) == "1" else "K4") + f", {t.group(3)} lanes"
                          + (", float64" if t.group(1) == "d" else ""))
            elif u:
                kernel = ("K4''b" if u.group(1) == "1" else "K4") + ", " + THREAD_NAMES[
                    "newton"][int(u.group(2))]
            else:
                continue
        else:
            t = re.search(r"prox3d_chord_kernelI([fd])Lb([01])ELi(\d+)E", name)
            u = re.search(r"prox3d_chord_thread_kernelILb([01])E", name)
            if t:
                kernel = (("K4'" if t.group(2) == "1" else "K4''a") + f", {t.group(3)} lanes"
                          + (", float64" if t.group(1) == "d" else ""))
            elif u:
                kernel = ("K4'" if u.group(1) == "1" else "K4''a") + ", one thread per element"
            else:
                continue
        rows.append((kernel, int(m.group(1)), *stack, smem))
    return rows


def build_all(builds, families):
    jobs = {}
    for i, (name, edit) in enumerate(builds.items()):
        d = os.path.join(OUT, str(i))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC, d)
        src = os.path.join(d, "prox3d.cu")
        with open(src) as f:
            text = edit(f.read())
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(d, "libprox3d.so")
        proc = subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, so, time.perf_counter())
    libs = {}
    for name, (proc, so, t0) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        print(f"{name}: built in {time.perf_counter() - t0:.1f} s", flush=True)
        for family in dict.fromkeys(PTXAS_FAMILY[f] for f in families):
            for kernel, regs, stack, st, ld, smem in _ptxas(out, family):
                print(f"  ptxas {kernel}: {regs} registers, {stack} bytes stack frame, {st} "
                      f"bytes spill stores, {ld} bytes spill loads, {smem} bytes shared",
                      flush=True)
        lib = ctypes.CDLL(so)
        for fn, sig in P3._SIGNATURES.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = sig
        if name == "thread":
            lib.mm_prox3d_thread.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                             + P3._TAIL[:3])
            lib.mm_prox3d_thread.restype = ctypes.c_int
        libs[name] = lib
    return libs


def cases(families):
    """``{label: (family, inputs, ehat or None, integrator, entry, plain)}``."""
    out = {}
    if "newton" in families:
        shoulder = C.box3d("Shoulder", 0, 40)[2]
        comp = C.comp_square(40, prox_chord=False)[2]
        out["K4 at 3D Shoulder-40 step 0"] = ("newton", C.prox_inputs(shoulder),
                                              shoulder.mesh.ehat_np.reshape(-1), shoulder,
                                              "mm_prox3d", P3.prox3d_plain)
        out["K4''b at 3D CompSquare-40 step 0"] = ("newton", C.stock_inputs(comp), None, comp,
                                                   "mm_prox3d_comp", P3.prox3d_comp_plain)
    if "newton64" in families:
        for tt, mon in (("Shoulder", 0), ("SquareGrid", 1)):
            integ = C.box3d(tt, mon, 40, dtype="float64")[2]
            out[f"K4 float64 at 3D {tt}-40 float64 step 0"] = (
                "newton64", C.prox_inputs(integ), integ.mesh.ehat_np.reshape(-1), integ,
                "mm_prox3d_f64", P3.prox3d_plain)
    if "chord64" in families:
        comp = C.f64_stock("3D CompSquare-40 float64 K4'", 40)[2]
        out["K4' float64 at 3D CompSquare-40 float64 step 0"] = (
            "chord64", C.stock_inputs(comp), None, comp, "mm_prox3d_chord_comp_f64",
            P3.prox3d_chord_comp_plain)
        square = C.square_chord(40, dtype="float64")[2]
        out["K4''a float64 at 3D SquareGrid-40 float64 step 0"] = (
            "chord64", C.stock_inputs(square), square.mesh.ehat_np.reshape(-1), square,
            "mm_prox3d_chord_f64", P3.prox3d_chord_plain)
    if "chord" in families:
        for n in (40, 20):
            comp = C.comp_square(n)[2]
            out[f"K4' at 3D CompSquare-{n} step 0"] = (
                "chord", C.stock_inputs(comp), None, comp, "mm_prox3d_chord_comp",
                P3.prox3d_chord_comp_plain)
        square = C.square_chord(40)[2]
        out["K4''a at 3D SquareGrid-40 step 0"] = (
            "chord", C.stock_inputs(square), square.mesh.ehat_np.reshape(-1), square,
            "mm_prox3d_chord", P3.prox3d_chord_plain)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("cuda_k4_variants: no CUDA device", file=sys.stderr)
        return 1
    families = [a for a in sys.argv[1:] if a in FAMILY_BUILDS] or list(FAMILY_BUILDS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}; torch {torch.__version__}", flush=True)
    builds = dict(BUILDS)
    for family in families:
        builds.update(FAMILY_BUILDS[family])
    libs = build_all(builds, families)
    for label, (family, inputs, ehat, integ, entry, plain) in cases(families).items():
        z, n = inputs[0], inputs[0].shape[1]
        comp_mesh = ehat is None
        real = ctypes.c_double if z.dtype == torch.float64 else ctypes.c_float
        consts = P3._consts3(integ.w, integ.prox_tol, z.dtype)
        k = (real * 9)(*consts) if comp_mesh else (real * 18)(*ehat, *consts)
        pargs = () if comp_mesh else (ehat,)
        zp, ihp = plain(*inputs, *pargs, integ.w, integ.prox_tol, integ.prox_max_iters)
        ptrs = [t.data_ptr() for t in inputs[:4]]
        eh_ptr = inputs[4].data_ptr() if comp_mesh else None
        order = [*THREAD_NAMES.get(family, {}), "as it is", *FAMILY_BUILDS[family]]
        times = {v: [] for v in order}
        for v in order + order[::-1]:
            zo, ih = torch.empty_like(z), torch.empty(n, dtype=z.dtype, device=z.device)
            if isinstance(v, int):
                def call(design=v):
                    return libs["thread"].mm_prox3d_thread(
                        design, *ptrs, eh_ptr, zo.data_ptr(), ih.data_ptr(), n, k,
                        integ.prox_max_iters)
            else:
                def call(lib=libs[v]):
                    args = [*ptrs] + ([eh_ptr] if comp_mesh else [])
                    return getattr(lib, entry)(*args, zo.data_ptr(), ih.data_ptr(), n, k,
                                               integ.prox_max_iters,
                                               torch.cuda.current_stream().cuda_stream)

            def checked(call=call, v=v):
                rc = call()
                if rc != 0:
                    raise RuntimeError(f"{label}, {v}: CUDA error {rc}")

            times[v].append(C.time_kernel(checked))
            if not (torch.equal(zo, zp) and torch.equal(ih, ihp)):
                raise AssertionError(f"{label}, {v}: not bit-equal to the plain version")
        print(f"{label} ({n} slots), bit-equal to the plain version in every variant:",
              flush=True)
        for v in order:
            name = THREAD_NAMES.get(family, {}).get(v, v)
            print(f"  {name}: {' and '.join(f'{t:.4f}' for t in times[v])} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
