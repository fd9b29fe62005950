"""The Newton-sweep kernels K4 and K4''b (``csrc/prox3d.cu``) against the
one-thread-per-element design, timed on the card.

    python3 scripts/cuda_k4_variants.py

Builds, by plain ``nvcc`` into the git-ignored
``mmadmm_tpu_torch/_build/k4_variants/``, copies of ``csrc/``:

- ``thread``: ``prox3d.cu`` with the one-thread-per-element Newton kernel
  added (``prox3d_thread_kernel<kComp, kLate>``: each thread sweeps its
  element alone, its inputs read from device memory where they are used,
  its Hessian triangle in shared memory [78][128]). With ``kLate`` it
  retires on the gradient after computing its step (the JAX order, which
  the port's K4 and K4''b kept until the group design), without it before
  the Hessian; the script generates this copy, so the design it replaced
  can be timed beside it on the same card;
- ``as it is``: ``prox3d.cu`` unchanged;
- ``G=4``, ``G=8``, ``G=16``: ``prox3d.cu`` with ``kGroup`` set to 4, 8 or
  16 lanes per element and no minimum of blocks an SM in the Newton
  kernels' ``__launch_bounds__`` (up to 255 registers), and at G = 4 also
  with a minimum of 3 and of 4 blocks of 128 threads an SM (at most 168 and
  128 registers).

It prints each build's ``-Xptxas -v`` registers, stack and spills for the
Newton kernels, then times every variant (median of 20 launches, CUDA
events) on the step-0 prox inputs of 3D Shoulder-40 (K4, 768,000 tet
slots) and of 3D CompSquare-40 with ``prox_chord=False`` (K4''b, 768,000
tets), in turns forward and back (late, early, as it is, the G=4 bounds,
G=8, G=16, then back again), with the card's name and power limit, and holds
every variant bit for bit to the plain version (``prox3d_plain``,
``prox3d_comp_plain``). Needs a CUDA card; run it from the root of the
repo.
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
GROUP = re.compile(r"constexpr int kGroup = \d+;")
LAUNCH = "template <bool kChord, bool kComp>\nint launch("

# The one-thread-per-element Newton sweep, with the retire test after the
# step (kLate, the JAX order) or before the Hessian, on prox3d.cu's helpers.
THREAD_KERNEL = r"""
template <bool kComp, bool kLate>
__global__ void __launch_bounds__(kThreads) prox3d_thread_kernel(
    const float* __restrict__ z_in, const float* __restrict__ dxpu_in,
    const float* __restrict__ free_in, const float* __restrict__ cells_in,
    const float* __restrict__ ehat_in, float* __restrict__ zout, float* __restrict__ ih0_out,
    long long n, Ehat3 eh, Consts3 k, int max_iters) {
  __shared__ float hess[kTri * kThreads];
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float* H = hess + threadIdx.x;
  const Cells cells{cells_in + e, n};
  float z[12], dxpu[12], fr[12], h_e[9];
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    z[c] = z_in[c * n + e];
    dxpu[c] = dxpu_in[c * n + e];
    fr[c] = free_in[c * n + e];
  }
  const float* h = eh.h;
  if constexpr (kComp) {
#pragma unroll
    for (int c = 0; c < 9; ++c) h_e[c] = ehat_in[c * n + e];
    h = h_e;
  }
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
    bool stalled = step_inf <= kEpsStall * (1.0f + absmax(z));
    if (kLate && it > 0 && gnorm < k.tol) break;
#pragma unroll
    for (int i = 0; i < 12; ++i) z[i] = z[i] + alpha * p[i];
    if (stalled) break;
  }
#pragma unroll
  for (int c = 0; c < 12; ++c) zout[c * n + e] = z[c];
}

template <bool kComp, bool kLate>
int launch_thread(const float* z, const float* dxpu, const float* free_, const float* cells,
                  const float* ehat, float* zout, float* ih0, long long n, const float* consts,
                  int max_iters) {
  if (n <= 0) return 0;
  Ehat3 eh{};
  Consts3 k;
  if constexpr (!kComp) std::memcpy(&eh, consts, sizeof(eh));
  std::memcpy(&k, consts + (kComp ? 0 : 9), sizeof(k));
  const long long blocks = (n + kThreads - 1) / kThreads;
  prox3d_thread_kernel<kComp, kLate><<<(unsigned)blocks, kThreads>>>(
      z, dxpu, free_, cells, ehat, zout, ih0, n, eh, k, max_iters);
  return (int)cudaGetLastError();
}

"""

THREAD_ENTRIES = r"""
extern "C" int mm_prox3d_thread(int late, const float* z, const float* dxpu, const float* fr,
                                const float* cells, const float* ehat, float* zout, float* ih0,
                                long long n, const float* consts, int max_iters) {
  if (ehat == nullptr)
    return late ? launch_thread<false, true>(z, dxpu, fr, cells, ehat, zout, ih0, n, consts,
                                             max_iters)
                : launch_thread<false, false>(z, dxpu, fr, cells, ehat, zout, ih0, n, consts,
                                              max_iters);
  return late ? launch_thread<true, true>(z, dxpu, fr, cells, ehat, zout, ih0, n, consts,
                                          max_iters)
              : launch_thread<true, false>(z, dxpu, fr, cells, ehat, zout, ih0, n, consts,
                                           max_iters);
}
"""

BOUNDS = "__launch_bounds__(kThreads, kComp ? kBlocksComp : kBlocks) prox3d_newton_kernel("


def _group(g, blocks):
    """prox3d.cu with kGroup = g and ``__launch_bounds__(kThreads,
    blocks)`` on the Newton kernels (no minimum where ``blocks`` is 0)."""
    def edit(s):
        if BOUNDS not in s:
            raise RuntimeError("prox3d.cu's Newton kernel bounds are not where this script "
                               "expects them")
        bounds = f"(kThreads, {blocks})" if blocks else "(kThreads)"
        s = GROUP.sub(f"constexpr int kGroup = {g};", s)
        return s.replace(BOUNDS, f"__launch_bounds__{bounds} prox3d_newton_kernel(")
    return edit


BUILDS = {
    "thread": lambda s: s.replace(LAUNCH, THREAD_KERNEL + LAUNCH) + THREAD_ENTRIES,
    "as it is": lambda s: s,
    "G=4, no block minimum": _group(4, 0),
    "G=4, 3 blocks an SM": _group(4, 3),
    "G=4, 4 blocks an SM": _group(4, 4),
    "G=8, no block minimum": _group(8, 0),
    "G=16, no block minimum": _group(16, 0),
}


def _ptxas(out: str):
    """``(kernel, registers, stack, spill stores, spill loads)`` of the
    Newton kernels in an ``nvcc -Xptxas -v`` log."""
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
        if m and name and ("newton" in name or "thread" in name):
            t = re.search(r"(newton|thread)_kernelILb([01])EL([bi])(\d+)E", name)
            kernel = "K4''b" if t.group(2) == "1" else "K4"
            if t.group(1) == "newton":
                kernel += f", {t.group(4)} lanes per element"
            else:
                kernel += ", one thread per element, retire " + (
                    "after the step" if t.group(4) == "1" else "before the Hessian")
            rows.append((kernel, int(m.group(1)), *stack))
    return rows


def build_all():
    jobs = {}
    for i, (name, edit) in enumerate(BUILDS.items()):
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
        for kernel, regs, stack, st, ld in _ptxas(out):
            print(f"  ptxas {kernel}: {regs} registers, {stack} bytes stack frame, {st} bytes "
                  f"spill stores, {ld} bytes spill loads", flush=True)
        lib = ctypes.CDLL(so)
        for fn, sig in P3._SIGNATURES.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = sig
        if name == "thread":
            lib.mm_prox3d_thread.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                             + P3._TAIL[:3])
            lib.mm_prox3d_thread.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("cuda_k4_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}; torch {torch.__version__}", flush=True)
    libs = build_all()
    _, _, shoulder = C.box3d("Shoulder", 0, 40)
    _, _, comp = C.comp_square(40, prox_chord=False)
    cases = {
        "K4 at 3D Shoulder-40 step 0": (
            C.prox_inputs(shoulder), shoulder.mesh.ehat_np.reshape(-1), shoulder, "mm_prox3d"),
        "K4''b at 3D CompSquare-40 step 0": (C.stock_inputs(comp), None, comp, "mm_prox3d_comp"),
    }
    order = ["late", "early", *list(BUILDS)[1:]]
    for label, (inputs, ehat, integ, entry) in cases.items():
        z, n = inputs[0], inputs[0].shape[1]
        comp_mesh = ehat is None
        consts = P3._consts3(integ.w, integ.prox_tol)
        k = ((ctypes.c_float * 9)(*consts) if comp_mesh
             else (ctypes.c_float * 18)(*ehat, *consts))
        plain = P3.prox3d_comp_plain if comp_mesh else P3.prox3d_plain
        pargs = () if comp_mesh else (ehat,)
        zp, ihp = plain(*inputs, *pargs, integ.w, integ.prox_tol, integ.prox_max_iters)
        ptrs = [t.data_ptr() for t in inputs[:4]]
        eh_ptr = inputs[4].data_ptr() if comp_mesh else None
        times = {v: [] for v in order}
        for v in order + order[::-1]:
            zo, ih = torch.empty_like(z), torch.empty(n, device=z.device)
            if v in ("late", "early"):
                def call(late=int(v == "late")):
                    return libs["thread"].mm_prox3d_thread(
                        late, *ptrs, eh_ptr, zo.data_ptr(), ih.data_ptr(), n, k,
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
            name = {"late": "one thread per element, retire after the step",
                    "early": "one thread per element, retire before the Hessian"}.get(v, v)
            print(f"  {name}: {' and '.join(f'{t:.4f}' for t in times[v])} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
