"""The 3D prox kernels of ``csrc/prox3d.cu`` against the designs they
replaced and against variants of their layouts, timed on the card.

    python3 scripts/cuda_k4_variants.py [newton] [chord] [newton64] [chord64] [comp64]
        [chord_box64] [--interleave=N] [--only='WORDS|...'] [--sass]

``newton`` times the float Newton-sweep kernels K4 and K4''b, ``chord`` the
float chord-sweep kernels K4' and K4''a, ``newton64`` K4's float64 build,
``chord64`` K4''s, ``comp64`` K4''b's and ``chord_box64`` K4''a's; with
no family named, all six. ``--only`` keeps, of the named families' builds,
the parent's and those whose names hold one of the words;
``--interleave=N`` times N single launches of each variant, one of every
variant a sweep, the order turned every sweep, against the card's drift
over a run (by default each variant is timed twice, a median of 20
launches each, in turns forward and back); ``--sass`` also counts each timed kernel's
instructions (``cuobjdump -sass``), to tell builds of the same code from
builds of other code. Each build is a copy of ``csrc/`` in the
git-ignored ``mmadmm_tpu_torch/_build/k4_variants/``, built by plain
``nvcc``, all started together. A build of a layout changes one alias of
``prox3d.cu`` (``NewtonFloat``, ``ChordFloat``, ``K4Double``,
``K4ChordCompDouble``, ``K4CompDouble``, ``K4ChordDouble``:
``Layout<threads a block, lanes an element, blocks an SM at least, factor,
samples shared out>``), some also a few lines of its text
(``GLOBAL_CELLS``, ``IN_ORDER``, ``CARVEOUT_50``, ``DYNAMIC_STAGE``,
``HESS_COLS``, ``NOINLINE``, ``INLINED``, ``ROLLED``, ``SPREAD_SOLVE``,
``HESS_N2``, ``HESS_N3``, ``BACKTRACK_IN_ROUNDS``, ``CHORD_FULL_FIRST``,
``SOLVE_OUT_OF_LINE``); the float64 variant
builds keep only the timed kernel's entry. The builds:

- ``shipped``: ``prox3d.cu`` as it is (every kernel's ``ptxas`` line);
- ``thread`` (with ``newton`` or ``chord``): ``prox3d.cu`` with two
  one-thread-per-element kernels added, each thread sweeping its element
  alone, its inputs read from device memory where they are used, its
  Hessian triangle in shared memory [78][128]: the Newton sweep
  ``prox3d_thread_kernel<kComp, kLate>`` (with ``kLate`` it retires on the
  gradient after computing its step, the JAX order, else before the
  Hessian) and the chord sweep ``prox3d_chord_thread_kernel<kComp>`` (the
  design K4' and K4''a had before their group design). The script
  generates this copy, so the designs the group kernels replaced can be
  timed beside them on the same card;
- Newton variants (float): 4, 8 or 16 lanes per element in blocks of 128
  threads with no minimum of blocks an SM (up to 255 registers), and at 4
  lanes a minimum of 3 and of 4 blocks an SM (at most 168 and 128
  registers);
- chord variants (float): 1, 2, 4 or 8 lanes per element (a block of 32
  elements: 32, 64, 128 or 256 threads; 1 lane is the staged design
  without a group) with no minimum; at 2 lanes a minimum of 5 and of 6
  blocks (at most 204 and 168 registers), at 4 lanes of 3 blocks (168); at
  2 and 4 lanes the factor in every lane's registers, one lane writing it
  back, instead of on one lane in place; at 2 and 4 lanes the dual pass
  (``hess_col``) as a function of its own (``__noinline__``); at 2 lanes
  the sweep loop kept rolled (``#pragma unroll 1``); and at 2 lanes,
  without a cap and with 6 blocks an SM, the solve with the cached factors
  (``cached_direction``) inlined;
- ``newton64``: K4 in float64 in the parent's layout (``PARENT_K4``: 16
  elements of 4 lanes a block of 64, the cells staged, every lane
  factoring a copy, at least 4 blocks an SM: K4''b's layout in float64) and
  the variants of ``NEWTON64``: the cells read from device memory
  (``GlobalCells``, or in program order) or staged, the factor on every
  lane, on one lane or spread over the group (``factor12_group``), 2, 4 or
  8 lanes, register caps for 8-16 warps an SM, a carve-out, 16-64
  elements a block in static or dynamic shared memory, the dual pass or
  the column loop out of line, the solve inlined;
- ``chord64``: K4' in float64 in the parent's layout (``PARENT_K4C``: 16
  elements of 2 lanes, a block of one warp, the cells staged, one lane
  factoring: K4''a's layout in float64) and the variants of ``CHORD64`` (the same kinds,
  and the sweep loop kept rolled);
- ``comp64`` and ``chord_box64``: K4''b and K4''a in float64 in the
  parent's layouts (``PARENT_K4PPB``: 4 lanes, every lane factoring a
  copy, at least 3 blocks an SM; ``PARENT_K4PPA``: 2 lanes in a block of
  one warp, one lane factoring) and the variants of ``COMP64`` and
  ``CHORD_BOX64``: K4's and K4''s plans, 2 lanes, the cached solve
  spread over the group (``SPREAD_SOLVE``), two or three Hessian columns a
  dual pass (``HESS_N2``, ``HESS_N3``: dual.cuh's ``DualN``), the samples
  of the group's common evaluations shared out (``GroupCells``), the
  backtracking in rounds of the five trials or alpha 1 first, the solve
  inlined, 32 or 64 elements a block in dynamic shared memory.

It prints each build's ``-Xptxas -v`` registers, stack, spills and shared
bytes and the blocks an SM holds of each timed kernel (the occupancy
calculator through ``mm_prox3d_layout``), then times every variant (median
of 20 launches, CUDA events) in turns forward and back, and holds every
variant bit for bit to the plain version (it exits 1 if a build fails or a
variant differs, after timing the rest), on:

- K4 at the step-0 prox inputs of 3D Shoulder-40 (768,000 tet slots) and
  K4''b at those of 3D CompSquare-40 with ``prox_chord=False`` (768,000
  tets), against ``prox3d_plain`` and ``prox3d_comp_plain``;
- K4' at the stock engine's step-0 inputs of 3D CompSquare-40 (768,000
  tets) and CompSquare-20 (96,000), and K4''a at those of 3D
  SquareGrid-40 with ``prox_chord=True`` (768,000), against
  ``prox3d_chord_comp_plain`` and ``prox3d_chord_plain``;
- K4's float64 build at the step-0 prox inputs of 3D Shoulder-40 and 3D
  SquareGrid-40 in float64, against ``prox3d_plain`` in float64;
- K4''s float64 build at the stock engine's step-0 inputs of 3D
  CompSquare-40 and CompSquare-20 in float64 on the kernel route, against
  ``prox3d_chord_comp_plain`` in float64;
- K4''b's float64 build at the stock engine's step-0 inputs of 3D
  CompSquare-40 and -20 in float64 with ``prox_chord=False`` and at the
  first prox call of step ``LATER_STEP`` (5) at -40 (the path run that
  far on the shipped build), against ``prox3d_comp_plain``; K4''a's at
  those of 3D SquareGrid-40 and -20 with ``prox_chord=True``, against
  ``prox3d_chord_plain``.

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
from mmadmm_tpu_torch.ops import prox3d as P3  # noqa: E402

OUT = os.path.join(cuda_build.BUILD_DIR, "k4_variants")
LAUNCH = "template <typename R, bool kChord, bool kComp>\nint launch("

# The one-thread-per-element designs, on prox3d.cu's helpers: the Newton
# sweep with the retire test after the step (kLate, the JAX order) or
# before the Hessian, and the chord sweep as K4' and K4''a had it.
THREAD_KERNELS = r"""
constexpr int kThreads = 128;  // threads a block

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


def _sub(s, old, new, count=-1):
    """``s`` with ``old`` replaced by ``new`` (the first ``count`` times;
    -1: everywhere)."""
    if old not in s:
        raise RuntimeError(f"prox3d.cu has no {old!r}, which this script edits")
    return s.replace(old, new, count)


def _alias(s, name, layout):
    """``s`` with the layout alias ``name`` of prox3d.cu set to ``layout``."""
    pattern = re.compile(r"using %s = [^;]*;" % name)
    if not pattern.search(s):
        raise RuntimeError(f"prox3d.cu has no alias {name}, which this script sets")
    return pattern.sub(lambda _: f"using {name} = {layout};", s, count=1)


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
    """The float Newton kernels at g lanes an element in blocks of 128
    threads, at least ``blocks`` blocks an SM (1: no minimum)."""
    def edit(s):
        return _alias(s, "NewtonFloat", f"Layout<128, {g}, {blocks}, kEveryLane>")
    return edit


def _chord(g, blocks, factor_one_lane=True, *edits):
    """The float chord kernels at g lanes an element (1 allowed too) in
    blocks of 32 elements, at least ``blocks`` blocks an SM (1: no
    minimum), the factor on one lane or in every lane's registers, then the
    ``(old, new)`` text edits."""
    def edit(s):
        for old, new in edits:
            s = _sub(s, old, new)
        s = _alias(s, "ChordFloat", f"Layout<{32 * g}, {g}, {blocks}, kOneLane>")
        s = _sub(s, CHORD_GROUPS, "static_assert(G == 1 || G == 2 || G == 4 || G == 8);")
        if not factor_one_lane:
            s = _sub(s, FACTOR, FACTOR_IN_REGISTERS)
        return s
    return edit


# K4 and K4' in float64 as the parent commit lays them out: 16 elements a block,
# the cells staged, K4 at 4 lanes with every lane factoring a copy and at
# least 4 blocks an SM, K4' at 2 lanes (one warp) with one lane factoring
PARENT_K4 = "Layout<64, 4, 4, kEveryLane>"
PARENT_K4C = "Layout<32, 2, 1, kOneLane>"
PARENT = "parent's layout"
# K4''b and K4''a in float64 as the parent commit lays them out: 16 elements
# a block, the cells staged, K4''b at 4 lanes with every lane factoring a
# copy and at least 3 blocks an SM, K4''a at 2 lanes (one warp) with one
# lane factoring
PARENT_K4PPB = "Layout<64, 4, 3, kEveryLane>"
PARENT_K4PPA = "Layout<32, 2, 1, kOneLane>"

# a block's stage in dynamic shared memory (over the 48 KB of static shared
# memory a block may have), its size set as the kernel's dynamic maximum
# before a launch or an occupancy query; for a build of one kernel
DYNAMIC_STAGE = (
    ("  __shared__ __align__(16) NewtonStage<R, kComp, kE> st;\n",
     "  extern __shared__ __align__(16) unsigned char stage_bytes[];\n"
     "  NewtonStage<R, kComp, kE>& st = *reinterpret_cast<NewtonStage<R, kComp, kE>*>(stage_bytes);\n"),
    ("  const auto kernel = kernel_of<R, kChord, kComp>();\n"
     "  kernel<<<(unsigned)blocks, D::kThreads, 0, (cudaStream_t)stream>>>(",
     "  const auto kernel = kernel_of<R, kChord, kComp>();\n"
     "  constexpr int kStage = (int)sizeof(NewtonStage<R, kComp, D::kE>);\n"
     "  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStage);\n"
     "  kernel<<<(unsigned)blocks, D::kThreads, kStage, (cudaStream_t)stream>>>("),
    ("  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel_of<R, kChord, kComp>(),\n"
     "                                                            D::kThreads, 0);",
     "  constexpr int kStage = (int)sizeof(NewtonStage<R, kComp, D::kE>);\n"
     "  cudaFuncSetAttribute(kernel_of<R, kChord, kComp>(),\n"
     "                       cudaFuncAttributeMaxDynamicSharedMemorySize, kStage);\n"
     "  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel_of<R, kChord, kComp>(),\n"
     "                                                            D::kThreads, kStage);"),
)
# a Hessian's column loop as a function of its own (__noinline__), in the
# Newton kernel's in-place branch and in the chord refresh: the dual passes
# get the registers without the sweep's state live around them
HESS_COLS = (
    ("// ---- Newton sweeps (K4, K4''b)",
     "template <int G, typename C, typename R>\n"
     "__device__ __noinline__ void hess_cols(int lane, const R* z, const C& cells, const R* h,\n"
     "                                       const R* dxpu, const R* fr, const Consts3<R>& k, "
     "R* H) {\n#pragma unroll 1\n"
     "  for (int j = lane; j < 12; j += G) hess_col<1>(j, z, cells, h, dxpu, fr, k, fr[j], H);\n"
     "}\n\n// ---- Newton sweeps (K4, K4''b)"),
    ("      __syncwarp(gmask);  // every lane has solved with the last sweep's factors\n"
     "#pragma unroll 1\n"
     "      for (int j = lane; j < 12; j += G) hess_col<1>(j, z, cells, h, dxpu, fr, k, fr[j], H);"
     "\n",
     "      __syncwarp(gmask);  // every lane has solved with the last sweep's factors\n"
     "      hess_cols<G>(lane, z, cells, h, dxpu, fr, k, H);\n"),
    ("#pragma unroll 1\n"
     "  for (int j = lane; j < 12; j += D::kGroup) hess_col<1>(j, z, cells, h, dxpu, fr, k, fr[j], "
     "H);\n",
     "  hess_cols<D::kGroup>(lane, z, cells, h, dxpu, fr, k, H);\n"),
)
# the cells read from device memory where they are used (GlobalCells), not
# staged: the stage keeps z, dxpu, free, Ehat and the triangle (912 and 984
# bytes an element in double); with in_order, by loads the compiler keeps
# in program order (volatile ld.global.nc), not hoisted ahead of their use
def global_cells(in_order=False):
    load = ("#ifdef __CUDA_ARCH__\n    R v;\n    if constexpr (sizeof(R) == 8)\n"
            "      asm volatile(\"ld.global.nc.f64 %0, [%1];\" : \"=d\"(v) : \"l\"(p + c * n));\n"
            "    else\n"
            "      asm volatile(\"ld.global.nc.f32 %0, [%1];\" : \"=f\"(v) : \"l\"(p + c * n));\n"
            "    return v;\n#else\n    return __ldg(p + c * n);\n#endif\n"
            if in_order else "    return __ldg(p + c * n);\n")
    return (
        ("// the block's inputs into its stage, then the block's only barrier\n",
         "template <typename R>\nstruct GlobalCells {\n  const R* p;  // cells + the element\n"
         "  long long n;\n  __device__ __forceinline__ R operator()(int c) const {\n" + load
         + "  }\n};\n\n// the block's inputs into its stage, then the block's only barrier\n"),
        ("  R cells[kCells * kE];\n", "  R cells[1];  // the cells stay in device memory\n"),
        ("  stage_rows<kE, kT>(st.cells, cells_in, kCells, n, first);\n", ""),
        ("  const SharedCells<R, kE> cells{st.cells + el};",
         "  const GlobalCells<R> cells{cells_in + e, n};"),
    )


# the Hessian's columns in dual passes of n tangents each (dual.cuh's DualN:
# every column's bits are those of hess_col's one-tangent pass): lane l of G
# takes its columns l, l + G, ... n to a pass, the last pass the rest; in the
# Newton kernel's in-place branch and in the chord refresh
HESS_COL_N = r"""// columns j0, j0 + G, ..., j0 + (N - 1) G of the lower triangle of the
// Hessian at z (rows i >= j), from one dual pass with N tangents; a column
// past 11 is left out
template <int N, int G, typename C, typename R>
__device__ __forceinline__ void hess_col_n(int j0, const R* z, const C& cells, const R* h,
                                           const R* dxpu, const R* fr, const Consts3<R>& k,
                                           R* H) {
  DualN<R, N> zd[12], gd[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    zd[i].v = z[i];
#pragma unroll
    for (int t = 0; t < N; ++t) zd[i].d[t] = i == j0 + t * G ? R(1) : R(0);
  }
  DualN<R, N> ihd;
  grad3<DualN<R, N>>(zd, cells, h, dxpu, fr, k, gd, ihd);
#pragma unroll
  for (int t = 0; t < N; ++t) {
    const int j = j0 + t * G;
    if (j >= 12) continue;
    const R frj = fr[j];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      if (i < j) continue;
      R hv = gd[i].d[t] * fr[i] * frj;
      if (i == j) hv = hv + (R(1) - fr[i]) + Num<R>::kLevenberg;
      H[tri(i, j)] = hv;
    }
  }
}

// lane's columns of the Hessian, N to a dual pass
template <int N, int G, typename C, typename R>
__device__ __forceinline__ void hess_cols_n(int lane, const R* z, const C& cells, const R* h,
                                            const R* dxpu, const R* fr, const Consts3<R>& k,
                                            R* H) {
  constexpr int kCols = (12 + G - 1) / G, kRest = kCols % N;
#pragma unroll 1
  for (int c = 0; c + N <= kCols; c += N)
    hess_col_n<N, G>(lane + c * G, z, cells, h, dxpu, fr, k, H);
  if constexpr (kRest > 0)
    hess_col_n<kRest, G>(lane + (kCols - kRest) * G, z, cells, h, dxpu, fr, k, H);
}

"""


def hess_passes(n):
    return (
        ("// ---- Newton sweeps (K4, K4''b)", HESS_COL_N + "// ---- Newton sweeps (K4, K4''b)"),
        ("      __syncwarp(gmask);  // every lane has solved with the last sweep's factors\n"
         "#pragma unroll 1\n"
         "      for (int j = lane; j < 12; j += G) "
         "hess_col<1>(j, z, cells, h, dxpu, fr, k, fr[j], H);\n",
         "      __syncwarp(gmask);  // every lane has solved with the last sweep's factors\n"
         f"      hess_cols_n<{n}, G>(lane, z, cells, h, dxpu, fr, k, H);\n"),
        ("#pragma unroll 1\n"
         "  for (int j = lane; j < 12; j += D::kGroup) "
         "hess_col<1>(j, z, cells, h, dxpu, fr, k, fr[j], H);\n",
         f"  hess_cols_n<{n}, D::kGroup>(lane, z, cells, h, dxpu, fr, k, H);\n"),
    )


HESS_N2, HESS_N3 = hess_passes(2), hess_passes(3)
# the solve out of line on a layout that shares samples out (inlined there
# in the source)
SOLVE_OUT_OF_LINE = (("  if constexpr (D::kShare)\n    direction<1>(H, g, inv_w2, p);\n  else\n",
                      ""),)
# the Newton sweep's backtracking in rounds of the five trials on a layout
# that shares samples out, as the other layouts do, instead of alpha 1 first
# on every lane
BACKTRACK_IN_ROUNDS = (("backtrack_group<D, D::kShare>(", "backtrack_group<D, false>("),)
# the chord sweep's backtracking with alpha 1 first, on a layout that shares
# samples out: in the first sweep in place of the trial at alpha 1 before it
CHORD_FULL_FIRST = (
    ("ok = it == 0 && trial_ok(z, p, R(1), ccells, h, dxpu, k, e0, det_floor);",
     "ok = !D::kShare && it == 0 && trial_ok(z, p, R(1), ccells, h, dxpu, k, e0, det_floor);"),
    ("backtrack_group<D, false>(z, p, cells, ccells, h, dxpu, k, e0,",
     "backtrack_group<D, D::kShare>(z, p, cells, ccells, h, dxpu, k, e0,"),
)
GLOBAL_CELLS = global_cells()
IN_ORDER = global_cells(in_order=True)
# shared memory's share of the SM's 256 KB asked for: 50 %
# (cudaFuncAttributePreferredSharedMemoryCarveout, a hint)
CARVEOUT_50 = (
    ("  const auto kernel = kernel_of<R, kChord, kComp>();\n",
     "  const auto kernel = kernel_of<R, kChord, kComp>();\n"
     "  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 50);\n"),
    ("  out[1] = D::kThreads;\n",
     "  cudaFuncSetAttribute(kernel_of<R, kChord, kComp>(),\n"
     "                       cudaFuncAttributePreferredSharedMemoryCarveout, 50);\n"
     "  out[1] = D::kThreads;\n"),
)
# the kernels' dual pass as a function of its own, their solve with a
# factored triangle in shared memory inlined, the chord sweep loop kept
# rolled
NOINLINE = (("__device__ __forceinline__ void hess_col(", "__device__ __noinline__ void hess_col("),)
INLINED = (("__device__ __noinline__ void cached_direction(",
            "__device__ __forceinline__ void cached_direction("),)
ROLLED = (("if (max_iters <= 0 && lane == 0) ih0_out[e] = energy3_unreg(z, cells, h, k);\n",
           "if (max_iters <= 0 && lane == 0) ih0_out[e] = energy3_unreg(z, cells, h, k);\n"
           "#pragma unroll 1\n"),)
DYNAMIC = "parent's stage of 32 elements a block of 128 in dynamic shared memory"
# the variants timed for K4 in float64 (newton64) and K4' in float64
# (chord64), beside the parent's: (Layout<threads, lanes, blocks an SM at
# least, factor>, text edits of prox3d.cu)
NEWTON64 = {
    DYNAMIC: ("Layout<128, 4, 2, kEveryLane>", DYNAMIC_STAGE),
    "cells from device memory, every lane factors, at least 4 blocks":
        ("Layout<64, 4, 4, kEveryLane>", GLOBAL_CELLS),
    "cells from device memory, every lane factors, at least 6 blocks":
        ("Layout<64, 4, 6, kEveryLane>", GLOBAL_CELLS),
    "cells from device memory, one lane factors, at least 6 blocks":
        ("Layout<64, 4, 6, kOneLane>", GLOBAL_CELLS),
    "cells from device memory, factor spread, at least 4 blocks":
        ("Layout<64, 4, 4, kSpread>", GLOBAL_CELLS),
    "cells from device memory, factor spread, at least 6 blocks":
        ("Layout<64, 4, 6, kSpread>", GLOBAL_CELLS),
    "cells from device memory, factor spread, at least 6 blocks, carve-out 50 %":
        ("Layout<64, 4, 6, kSpread>", GLOBAL_CELLS + CARVEOUT_50),
    "cells from device memory, factor spread, at least 8 blocks":
        ("Layout<64, 4, 8, kSpread>", GLOBAL_CELLS),
    "cells from device memory, factor spread, 32 elements a block of 128, at least 3 blocks":
        ("Layout<128, 4, 3, kSpread>", GLOBAL_CELLS),
    "cells from device memory, factor spread, 32 elements a block of 128, at least 4 blocks":
        ("Layout<128, 4, 4, kSpread>", GLOBAL_CELLS),
    "cells from device memory, factor spread, 2 lanes, 32 elements a block of 64, at least 6 "
    "blocks": ("Layout<64, 2, 6, kSpread>", GLOBAL_CELLS),
    "cells from device memory in program order, factor spread, at least 6 blocks":
        ("Layout<64, 4, 6, kSpread>", IN_ORDER),
    "cells staged, factor spread, at least 5 blocks": ("Layout<64, 4, 5, kSpread>", ()),
    "cells staged, factor spread, dual pass out of line": ("Layout<64, 4, 4, kSpread>", NOINLINE),
    "cells staged, factor spread, Hessian columns out of line":
        ("Layout<64, 4, 4, kSpread>", HESS_COLS),
    "cells staged, factor spread, solve inlined": ("Layout<64, 4, 4, kSpread>", INLINED),
    "cells staged, factor spread, 8 lanes (8 elements a block of 64)":
        ("Layout<64, 8, 4, kSpread>", ()),
    "cells staged, factor spread, 2 lanes (16 elements a block of 32)":
        ("Layout<32, 2, 1, kSpread>", ()),
    "cells staged, factor spread, 16 elements a block of 64 in dynamic shared memory":
        ("Layout<64, 4, 4, kSpread>", DYNAMIC_STAGE),
    "cells staged, factor spread, 32 elements a block of 128 in dynamic shared memory":
        ("Layout<128, 4, 2, kSpread>", DYNAMIC_STAGE),
    "cells staged, factor spread, 32 elements a block of 128 in dynamic shared memory, solve "
    "inlined": ("Layout<128, 4, 2, kSpread>", DYNAMIC_STAGE + INLINED),
    "cells staged, factor spread, 64 elements a block of 256 in dynamic shared memory":
        ("Layout<256, 4, 1, kSpread>", DYNAMIC_STAGE),
}
CHORD64 = {
    "cells from device memory, one lane factors, 16 elements a block of 32":
        ("Layout<32, 2, 1, kOneLane>", GLOBAL_CELLS),
    "cells from device memory, factor spread, 16 elements a block of 32":
        ("Layout<32, 2, 1, kSpread>", GLOBAL_CELLS),
    "cells from device memory, factor spread, 16 elements a block of 32, at least 12 blocks":
        ("Layout<32, 2, 12, kSpread>", GLOBAL_CELLS),
    "cells from device memory, one lane factors, 32 elements a block of 64":
        ("Layout<64, 2, 1, kOneLane>", GLOBAL_CELLS),
    "cells from device memory, one lane factors, 32 elements a block of 64, at least 6 blocks":
        ("Layout<64, 2, 6, kOneLane>", GLOBAL_CELLS),
    "cells from device memory, factor spread, 32 elements a block of 64, at least 6 blocks":
        ("Layout<64, 2, 6, kSpread>", GLOBAL_CELLS),
    "cells from device memory, factor spread, 32 elements a block of 64, at least 6 blocks, "
    "carve-out 50 %": ("Layout<64, 2, 6, kSpread>", GLOBAL_CELLS + CARVEOUT_50),
    "cells from device memory, factor spread, 32 elements a block of 64, at least 8 blocks":
        ("Layout<64, 2, 8, kSpread>", GLOBAL_CELLS),
    "cells from device memory, factor spread, 4 lanes, 16 elements a block of 64, at least 6 "
    "blocks": ("Layout<64, 4, 6, kSpread>", GLOBAL_CELLS),
    "cells staged, factor spread, 16 elements a block of 32": ("Layout<32, 2, 1, kSpread>", ()),
    "cells staged, factor spread, dual pass out of line": ("Layout<32, 2, 1, kSpread>", NOINLINE),
    "cells staged, factor spread, Hessian columns out of line":
        ("Layout<32, 2, 1, kSpread>", HESS_COLS),
    "cells staged, factor spread, solve inlined": ("Layout<32, 2, 1, kSpread>", INLINED),
    "cells staged, factor spread, sweep loop rolled": ("Layout<32, 2, 1, kSpread>", ROLLED),
    "cells staged, factor spread, 4 lanes, Hessian columns out of line":
        ("Layout<64, 4, 1, kSpread>", HESS_COLS),
    "cells staged, factor spread, 4 lanes, sweep loop rolled": ("Layout<64, 4, 1, kSpread>", ROLLED),
    "cells staged, factor spread, 8 lanes (16 elements a block of 128)":
        ("Layout<128, 8, 1, kSpread>", ()),
    "cells staged, factor spread, 2 lanes, 32 elements a block of 64 in dynamic shared memory":
        ("Layout<64, 2, 2, kSpread>", DYNAMIC_STAGE),
    "cells staged, factor spread, 4 lanes, 32 elements a block of 128 in dynamic shared memory":
        ("Layout<128, 4, 2, kSpread>", DYNAMIC_STAGE),
}


# the cached solve (direction<1>) by the group: the forward substitution's
# rows spread over the lanes (lane l the rows l, l + G, ...), each row's
# updates in direction's order as each solved entry arrives from the lane
# that owns its row (__shfl_sync within gmask), the divisions by the
# diagonal spread the same way and broadcast, then every lane the back
# substitution; each entry's operations in direction's order
SOLVE_GROUP = r"""
template <int G, typename R>
__device__ __noinline__ void cached_direction_group(const R* H, const R* g, R inv_w2, R* p,
                                                    int lane, int base, unsigned gmask) {
  constexpr int kRows = (12 + G - 1) / G;
  R s[kRows];  // the rows lane + r G
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = lane + r * G < 12 ? -g[lane + r * G] : R(0);
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const R zk = __shfl_sync(gmask, s[k / G], base + k % G);  // row k, solved
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = lane + r * G;
      if (i > k && i < 12) s[r] = s[r] - H[tri(i, k)] * zk;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (lane + r * G < 12) s[r] = s[r] / H[tri(lane + r * G, lane + r * G)];
  R q[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) q[i] = __shfl_sync(gmask, s[i / G], base + i % G);
#pragma unroll
  for (int i = 11; i >= 0; --i) {
    R t = q[i];
#pragma unroll
    for (int k = i + 1; k < 12; ++k) t = t - H[tri(k, i)] * p[k];
    p[i] = t;
  }
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 12; ++i) finite = finite && isfinite(p[i]);
  if (!finite) {
#pragma unroll
    for (int i = 0; i < 12; ++i) p[i] = -g[i] * inv_w2;
  }
}

"""
SPREAD_SOLVE = (
    ("// the triangle H in shared memory, whose columns the group has written,\n",
     SOLVE_GROUP + "// the triangle H in shared memory, whose columns the group has written,\n"),
    ("solve<D>(H, g, k.inv_w2, p);",
     "cached_direction_group<G>(H, g, k.inv_w2, p, lane, base, gmask);"),
)

# the variants timed for K4''b in float64 (comp64) and K4''a in float64
# (chord_box64), beside the parent's, as NEWTON64 and CHORD64
COMP64 = {
    "factor spread, at least 4 blocks (K4's layout)": ("Layout<64, 4, 4, kSpread>", ()),
    "one lane factors, at least 4 blocks": ("Layout<64, 4, 4, kOneLane>", ()),
    "factor spread, solve spread over the group": ("Layout<64, 4, 4, kSpread>", SPREAD_SOLVE),
    "factor spread, solve inlined": ("Layout<64, 4, 4, kSpread>", INLINED),
    "factor spread, 2 lanes (16 elements a block of 32)": ("Layout<32, 2, 1, kSpread>", ()),
    "factor spread, 32 elements a block of 128 in dynamic shared memory":
        ("Layout<128, 4, 2, kSpread>", DYNAMIC_STAGE),
    "factor spread, 32 elements a block of 128 in dynamic shared memory, solve inlined":
        ("Layout<128, 4, 2, kSpread>", DYNAMIC_STAGE + INLINED),
    "factor spread, 32 elements a block of 128 in dynamic shared memory, solve spread":
        ("Layout<128, 4, 2, kSpread>", DYNAMIC_STAGE + SPREAD_SOLVE),
    "factor spread, 64 elements a block of 256 in dynamic shared memory":
        ("Layout<256, 4, 1, kSpread>", DYNAMIC_STAGE),
    "factor spread, 2 Hessian columns a dual pass": ("Layout<64, 4, 4, kSpread>", HESS_N2),
    "factor spread, 3 Hessian columns a dual pass": ("Layout<64, 4, 4, kSpread>", HESS_N3),
    "factor spread, 2 Hessian columns a dual pass, solve inlined":
        ("Layout<64, 4, 4, kSpread>", HESS_N2 + INLINED),
    "factor spread, 3 Hessian columns a dual pass, solve inlined":
        ("Layout<64, 4, 4, kSpread>", HESS_N3 + INLINED),
    "factor spread, samples shared out, backtracking in rounds":
        ("Layout<64, 4, 4, kSpread, true>", SOLVE_OUT_OF_LINE + BACKTRACK_IN_ROUNDS),
    "factor spread, samples shared out, solve inlined, backtracking in rounds":
        ("Layout<64, 4, 4, kSpread, true>", BACKTRACK_IN_ROUNDS),
    "factor spread, samples shared out": ("Layout<64, 4, 4, kSpread, true>", SOLVE_OUT_OF_LINE),
    "factor spread, samples shared out, solve inlined (the shipped layout)":
        ("Layout<64, 4, 4, kSpread, true>", ()),
    "factor spread, samples shared out, 32 elements a block of 128 in dynamic shared memory, "
    "backtracking in rounds":
        ("Layout<128, 4, 2, kSpread, true>",
         DYNAMIC_STAGE + SOLVE_OUT_OF_LINE + BACKTRACK_IN_ROUNDS),
    "factor spread, samples shared out, solve inlined, 32 elements a block of 128 in dynamic "
    "shared memory": ("Layout<128, 4, 2, kSpread, true>", DYNAMIC_STAGE),
}
CHORD_BOX64 = {
    "4 lanes, 16 elements a block of 64, factor spread (K4''s layout)":
        ("Layout<64, 4, 1, kSpread>", ()),
    "2 lanes, 16 elements a block of 32, factor spread": ("Layout<32, 2, 1, kSpread>", ()),
    "4 lanes, factor spread, solve spread over the group":
        ("Layout<64, 4, 1, kSpread>", SPREAD_SOLVE),
    "2 lanes, factor spread, solve spread over the group":
        ("Layout<32, 2, 1, kSpread>", SPREAD_SOLVE),
    "4 lanes, factor spread, sweep loop rolled": ("Layout<64, 4, 1, kSpread>", ROLLED),
    "4 lanes, factor spread, 32 elements a block of 128 in dynamic shared memory":
        ("Layout<128, 4, 2, kSpread>", DYNAMIC_STAGE),
    "4 lanes, factor spread, 64 elements a block of 256 in dynamic shared memory":
        ("Layout<256, 4, 1, kSpread>", DYNAMIC_STAGE),
    "2 lanes, factor spread, 32 elements a block of 64 in dynamic shared memory":
        ("Layout<64, 2, 2, kSpread>", DYNAMIC_STAGE),
    "4 lanes, factor spread, 32 elements a block of 128 in dynamic shared memory, solve spread":
        ("Layout<128, 4, 2, kSpread>", DYNAMIC_STAGE + SPREAD_SOLVE),
    "4 lanes, factor spread, 2 Hessian columns a dual pass":
        ("Layout<64, 4, 1, kSpread>", HESS_N2),
    "4 lanes, factor spread, 3 Hessian columns a dual pass":
        ("Layout<64, 4, 1, kSpread>", HESS_N3),
    "2 lanes, factor spread, 2 Hessian columns a dual pass":
        ("Layout<32, 2, 1, kSpread>", HESS_N2),
    "2 lanes, factor spread, 3 Hessian columns a dual pass":
        ("Layout<32, 2, 1, kSpread>", HESS_N3),
    "4 lanes, factor spread, samples shared out":
        ("Layout<64, 4, 1, kSpread, true>", SOLVE_OUT_OF_LINE),
    "2 lanes, factor spread, samples shared out":
        ("Layout<32, 2, 1, kSpread, true>", SOLVE_OUT_OF_LINE),
    "4 lanes, factor spread, samples shared out, alpha 1 first":
        ("Layout<64, 4, 1, kSpread, true>", SOLVE_OUT_OF_LINE + CHORD_FULL_FIRST),
    "4 lanes, factor spread, samples shared out, solve inlined (the shipped layout)":
        ("Layout<64, 4, 1, kSpread, true>", ()),
    "4 lanes, factor spread, samples shared out, solve inlined, alpha 1 first":
        ("Layout<64, 4, 1, kSpread, true>", CHORD_FULL_FIRST),
    "4 lanes, factor spread, samples shared out, 32 elements a block of 128 in dynamic shared "
    "memory": ("Layout<128, 4, 2, kSpread, true>", DYNAMIC_STAGE + SOLVE_OUT_OF_LINE),
    "4 lanes, factor spread, samples shared out, solve inlined, 32 elements a block of 128 in "
    "dynamic shared memory": ("Layout<128, 4, 2, kSpread, true>", DYNAMIC_STAGE),
    "4 lanes, factor spread, samples shared out, solve inlined, 64 elements a block of 256 in "
    "dynamic shared memory": ("Layout<256, 4, 1, kSpread, true>", DYNAMIC_STAGE),
}


def apply_edits(s, edits):
    """prox3d.cu with the text ``edits`` ((old, new[, count]), in order)."""
    for old, new, *count in edits:
        s = _sub(s, old, new, *count)
    return s


def edited(s, alias, layout, edits=()):
    """prox3d.cu with the text ``edits`` and the layout alias ``alias`` set
    to ``layout``."""
    return _alias(apply_edits(s, edits), alias, layout)


# the layout entry of a build cut to one kernel: (chord, comp, f64)
LAYOUT_ONE = """
extern "C" int mm_prox3d_layout(int, int, int, int* out) {{
  return layout_of<{real}, {chord}, {comp}>(out);
}}
"""


def _only(s, entry, build, *more):
    """``s`` with its C entries cut to ``entry`` and the layout entry of
    ``build`` ((chord, comp, f64)) alone: a build of one kernel; with
    ``more`` (entry, build) pairs, a build of those kernels together, the
    layout entry choosing among them."""
    head = s[:s.index("}  // namespace\n") + len("}  // namespace\n")]
    kernels = ((entry, build),) + more
    entries = "".join(re.search(r'extern "C" int %s\(.*?\n}\n' % e, s, re.S).group(0)
                      for e, _ in kernels)
    layouts = [LAYOUT_ONE.format(real="double" if f64 else "float",
                                 chord=str(bool(chord)).lower(), comp=str(bool(comp)).lower())
               for _, (chord, comp, f64) in kernels]
    if not more:
        return head + "\n" + entries + layouts[0]
    cases = "".join(
        f"  if (chord == {c} && comp == {m} && f64 == {f}) "
        + re.search(r"return layout_of<[^;]*;", text).group(0) + "\n"
        for (_, (c, m, f)), text in zip(kernels, layouts))
    return (head + "\n" + entries + 'extern "C" int mm_prox3d_layout(int chord, int comp, int '
            "f64, int* out) {\n" + cases + "  return (int)cudaErrorInvalidValue;\n}\n")


K4_F64 = ("mm_prox3d_f64", (0, 0, 1))
K4C_F64 = ("mm_prox3d_chord_comp_f64", (1, 1, 1))
K4PPB_F64 = ("mm_prox3d_comp_f64", (0, 1, 1))
K4PPA_F64 = ("mm_prox3d_chord_f64", (1, 0, 1))


def _double(alias, variant, kernel):
    """A build of one float64 kernel: ``variant`` (layout, edits)."""
    def build(s):
        return _only(edited(s, alias, *variant), *kernel)
    return build


SHIPPED = "shipped (the source)"
BUILDS = {SHIPPED: lambda s: s}
THREAD_BUILD = {"thread": lambda s: _sub(s, LAUNCH, THREAD_KERNELS + LAUNCH) + THREAD_ENTRY}
NEWTON_BUILDS = {
    "Newton G=4, no block minimum": _newton(4, 1),
    "Newton G=4, 3 blocks an SM": _newton(4, 3),
    "Newton G=4, 4 blocks an SM": _newton(4, 4),
    "Newton G=8, no block minimum": _newton(8, 1),
    "Newton G=16, no block minimum": _newton(16, 1),
}
CHORD_BUILDS = {
    "chord G=1, no block minimum": _chord(1, 1),
    "chord G=2, no block minimum": _chord(2, 1),
    "chord G=2, 5 blocks an SM": _chord(2, 5),
    "chord G=2, 6 blocks an SM": _chord(2, 6),
    "chord G=2, no block minimum, factor in registers": _chord(2, 1, False),
    "chord G=4, no block minimum": _chord(4, 1),
    "chord G=4, 3 blocks an SM": _chord(4, 3),
    "chord G=4, no block minimum, factor in registers": _chord(4, 1, False),
    "chord G=8, no block minimum": _chord(8, 1),
    "chord G=2, no block minimum, dual pass not inlined": _chord(2, 1, True, *NOINLINE),
    "chord G=4, no block minimum, dual pass not inlined": _chord(4, 1, True, *NOINLINE),
    "chord G=2, no block minimum, sweep loop rolled": _chord(2, 1, True, *ROLLED),
    "chord G=2, no block minimum, solve inlined": _chord(2, 1, True, *INLINED),
    "chord G=2, 6 blocks an SM, solve inlined": _chord(2, 6, True, *INLINED),
}
NEWTON64_BUILDS = {f"K4 float64, {name}": _double("K4Double", variant, K4_F64)
                   for name, variant in {PARENT: (PARENT_K4, ()), **NEWTON64}.items()}
CHORD64_BUILDS = {f"K4' float64, {name}": _double("K4ChordCompDouble", variant, K4C_F64)
                  for name, variant in {PARENT: (PARENT_K4C, ()), **CHORD64}.items()}
# the shipped source built again, and its two float64 stock-engine builds
# (K4''b, K4''a) as shipped, built alone together: what their code is in
# a translation unit of their own
TOGETHER = {
    "shipped, built again": lambda s: s,
    "K4''b and K4''a float64 as shipped, built together alone":
        lambda s: _only(s, *K4PPB_F64, K4PPA_F64),
}
COMP64_BUILDS = {f"K4''b float64, {name}": _double("K4CompDouble", variant, K4PPB_F64)
                 for name, variant in {PARENT: (PARENT_K4PPB, ()), **COMP64}.items()}
CHORD_BOX64_BUILDS = {f"K4''a float64, {name}": _double("K4ChordDouble", variant, K4PPA_F64)
                      for name, variant in {PARENT: (PARENT_K4PPA, ()), **CHORD_BOX64}.items()}
COMP64_BUILDS.update(TOGETHER)
CHORD_BOX64_BUILDS.update(TOGETHER)
FAMILY_BUILDS = {"newton": NEWTON_BUILDS, "chord": CHORD_BUILDS, "newton64": NEWTON64_BUILDS,
                 "chord64": CHORD64_BUILDS, "comp64": COMP64_BUILDS,
                 "chord_box64": CHORD_BOX64_BUILDS}
THREAD_NAMES = {
    "newton": {0: "one thread per element, retire before the Hessian",
               1: "one thread per element, retire after the step"},
    "chord": {2: "one thread per element (the design before the group)"},
}
# the builds (chord, comp, f64) a family times
FAMILY_KERNELS = {"newton": ((0, 0, 0), (0, 1, 0)), "chord": ((1, 1, 0), (1, 0, 0)),
                  "newton64": ((0, 0, 1),), "chord64": ((1, 1, 1),), "comp64": ((0, 1, 1),),
                  "chord_box64": ((1, 0, 1),)}
FACTOR_NAMES = {"0": "every lane factors", "1": "one lane factors", "2": "factor spread"}
# the eight builds of prox3d.cu, (chord, comp, f64), and their names
KERNEL_NAMES = {(c, m, f): ({(0, 0): "K4", (0, 1): "K4''b", (1, 1): "K4'", (1, 0): "K4''a"}[c, m]
                            + (" float64" if f else " float32"))
                for c in (0, 1) for m in (0, 1) for f in (0, 1)}
ALL_KERNELS = tuple(KERNEL_NAMES)


def _kernel_name(mangled):
    """A readable name of a kernel in a ptxas log, or None."""
    t = re.search(r"prox3d_(newton|chord)_kernelI([fd])Lb([01])E.*?LayoutILi(\d+)ELi(\d+)ELi(\d+)E"
                  r"Li(\d+)ELb([01])E", mangled)
    if t:
        kind, real, comp, threads, lanes, blocks, factor, share = t.groups()
        name = {("newton", "0"): "K4", ("newton", "1"): "K4''b", ("chord", "1"): "K4'",
                ("chord", "0"): "K4''a"}[kind, comp]
        return (f"{name} {'float64' if real == 'd' else 'float32'}, {threads} threads, {lanes} "
                f"lanes, at least {blocks} blocks an SM, {FACTOR_NAMES[factor]}"
                + (", samples shared out" if share == "1" else ""))
    u = re.search(r"prox3d_thread_kernelILb([01])ELb([01])E", mangled)
    if u:
        return ("K4''b" if u.group(1) == "1" else "K4") + ", " + THREAD_NAMES["newton"][
            int(u.group(2))]
    u = re.search(r"prox3d_chord_thread_kernelILb([01])E", mangled)
    if u:
        return ("K4'" if u.group(1) == "1" else "K4''a") + ", one thread per element"
    return None


def _ptxas(out: str):
    """``(kernel, registers, stack, spill stores, spill loads, shared
    bytes)`` of the 3D prox kernels in an ``nvcc -Xptxas -v`` log."""
    rows, name, stack = [], None, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
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
        rows.append((name, int(m.group(1)), *stack, int(smem.group(1)) if smem else 0))
        name = None
    return rows


def sass_counts(so: str):
    """``{kernel: SASS instructions}`` of the 3D prox kernels in a built
    library (``cuobjdump -sass`` of the toolkit)."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    counts = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = _kernel_name(func.split("\n", 1)[0])
        if name:
            counts[name] = sum(1 for line in func.split("\n")[1:]
                               if re.match(r"\s*/\*[0-9a-f]{4,}\*/", line))
    return counts


def resident(lib, build):
    """``(blocks an SM, threads a block)`` of the kernel ``build`` ((chord,
    comp, f64)) of a loaded library."""
    chord, comp, f64 = build
    entry = {(0, 0): "mm_prox3d", (0, 1): "mm_prox3d_comp", (1, 0): "mm_prox3d_chord",
             (1, 1): "mm_prox3d_chord_comp"}[chord, comp] + ("_f64" if f64 else "")
    return P3.layout(entry, lib)[:2]


# the builds that failed to build or to agree with the plain version
FAILED = []
# the step whose first prox call gives comp64's and chord_box64's later
# inputs: the path runs that many steps on the shipped build first
LATER_STEP = 5


def build_all(builds, families, sass=False):
    jobs = {}
    os.makedirs(OUT, exist_ok=True)
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
    print(f"{len(jobs)} builds started together", flush=True)
    libs = {}
    for name, (proc, so, t0) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            FAILED.append(name)
            print(f"{name}: nvcc failed, not timed\n{out[-3000:]}", flush=True)
            continue
        print(f"{name}: built in {time.perf_counter() - t0:.1f} s", flush=True)
        for kernel, regs, stack, st, ld, smem in _ptxas(out):
            print(f"  ptxas {kernel}: {regs} registers, {stack} bytes stack frame, {st} "
                  f"bytes spill stores, {ld} bytes spill loads, {smem} bytes shared", flush=True)
        if sass:
            for kernel, count in sass_counts(so).items():
                print(f"  SASS {kernel}: {count} instructions", flush=True)
        lib = ctypes.CDLL(so)
        for fn, sig in P3._SIGNATURES.items():
            f = getattr(lib, fn, None)
            if f is not None:
                f.argtypes, f.restype = sig
        if name == "thread":
            lib.mm_prox3d_thread.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                             + P3._TAIL[:3])
            lib.mm_prox3d_thread.restype = ctypes.c_int
        else:
            for b in ALL_KERNELS if name == SHIPPED else FAMILY_KERNELS[_family_of(name)]:
                blocks, threads = resident(lib, b)
                print(f"  resident, {KERNEL_NAMES[b]}: {blocks} blocks of {threads} threads an "
                      f"SM = {blocks * threads // 32} warps", flush=True)
        libs[name] = lib
    return libs


def _family_of(build):
    for family, builds in FAMILY_BUILDS.items():
        if build in builds:
            return family
    return None


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
        for n in (40, 20):
            comp = C.f64_stock(f"3D CompSquare-{n} float64 K4'", n)[2]
            out[f"K4' float64 at 3D CompSquare-{n} float64 step 0"] = (
                "chord64", C.stock_inputs(comp), None, comp, "mm_prox3d_chord_comp_f64",
                P3.prox3d_chord_comp_plain)
    for family, name, path, entry, plain in (
            ("comp64", "K4''b", "3D CompSquare-{} float64", "mm_prox3d_comp_f64",
             P3.prox3d_comp_plain),
            ("chord_box64", "K4''a", "3D SquareGrid-{} float64", "mm_prox3d_chord_f64",
             P3.prox3d_chord_plain)):
        if family not in families:
            continue
        for n, steps in ((40, 0), (20, 0), (40, LATER_STEP)):
            integ = C.f64_stock(f"{path.format(n)} {name}", n)[2]
            state = integ.init_state()
            for _ in range(steps):
                state, _ = integ.step(state)
            ehat = None if integ.mesh.comp_mesh else integ.mesh.ehat_np.reshape(-1)
            out[f"{name} float64 at {path.format(n)} step {steps}"] = (
                family, C.stock_inputs(integ, state), ehat, integ, entry, plain)
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
    opts = dict(a[2:].split("=", 1) for a in sys.argv[1:] if a.startswith("--") and "=" in a)
    interleave = int(opts.get("interleave", 0))
    only = [w for w in opts.get("only", "").split("|") if w]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}; torch {torch.__version__}", flush=True)
    builds = dict(BUILDS)
    if "newton" in families or "chord" in families:
        builds.update(THREAD_BUILD)
    for family in families:
        builds.update({name: b for name, b in FAMILY_BUILDS[family].items()
                       if not only or PARENT in name or any(w in name for w in only)})
    libs = build_all(builds, families, sass="--sass" in sys.argv[1:])
    if SHIPPED in libs:  # the paths that cases() runs take the shipped build made here
        cuda_build._loaded.setdefault("prox3d", libs[SHIPPED])
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
        order = [v for v in (*THREAD_NAMES.get(family, {}), SHIPPED, *FAMILY_BUILDS[family])
                 if isinstance(v, int) or v in libs]
        times, differ, outs = {v: [] for v in order}, {}, {}

        def launcher(v):
            """One launch of variant ``v`` into its own outputs."""
            zo, ih = torch.empty_like(z), torch.empty(n, dtype=z.dtype, device=z.device)
            outs[v] = (zo, ih)
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

            def checked():
                rc = call()
                if rc != 0:
                    raise RuntimeError(f"{label}, {v}: CUDA error {rc}")
            return checked

        launch = {v: launcher(v) for v in order}
        if interleave:  # one launch of each variant a sweep, the order turned every sweep
            for v in order:
                launch[v]()
            for i in range(interleave):
                for v in order if i % 2 == 0 else order[::-1]:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    launch[v]()
                    b.record()
                    b.synchronize()
                    times[v].append(a.elapsed_time(b))
        else:
            for v in order + order[::-1]:
                times[v].append(C.time_kernel(launch[v]))
        for v in order:
            if not (torch.equal(outs[v][0], zp) and torch.equal(outs[v][1], ihp)):
                differ[v] = True
        print(f"{label} ({n} slots), each variant against the plain version:", flush=True)
        for v in order:
            name = THREAD_NAMES.get(family, {}).get(v, v)
            if interleave:
                q = statistics.quantiles(times[v], n=4)
                shown = (f"median {statistics.median(times[v]):.4f} ms of {interleave} launches "
                         f"(quartiles {q[0]:.4f}, {q[2]:.4f})")
            else:
                shown = f"{' and '.join(f'{t:.4f}' for t in times[v])} ms"
            print(f"  {name}: {shown}" + (", NOT bit-equal" if differ.get(v) else ", bit-equal"),
                  flush=True)
        FAILED.extend(f"{label}, {v}" for v in differ)
    if FAILED:
        print(f"failed: {FAILED}", flush=True)
    return int(bool(FAILED))


if __name__ == "__main__":
    sys.exit(main())
