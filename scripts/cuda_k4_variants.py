"""Launch-configuration variants of kernel K4 (``csrc/prox3d.cu``), timed
against each other on the card.

    python3 scripts/cuda_k4_variants.py

Builds ``prox3d.cu`` as it is and with one change each (64 or 256
threads per block, ``__launch_bounds__(128, 1)``, the twelve Hessian dual
passes unrolled, ``-maxrregcount=255``) by plain ``nvcc`` into the
git-ignored ``mmadmm_tpu_torch/_build/k4_variants/``, prints each build's
``-Xptxas -v`` registers and spills, then times every variant on the
step-0 prox inputs of 3D Shoulder-40 (768,000 tet slots; median of 20
launches, CUDA events) in turns, forward and back, and checks that each
gives the unchanged kernel's output bit for bit. Needs a CUDA card; run it
from the root of the repo.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as C  # noqa: E402
from mmadmm_tpu_torch import cuda_build  # noqa: E402
from mmadmm_tpu_torch.ops import prox3d as P3  # noqa: E402
from mmadmm_tpu_torch.ops.newton import consts  # noqa: E402

OUT = os.path.join(cuda_build.BUILD_DIR, "k4_variants")
LAUNCH = "prox3d_kernel<<<(unsigned)blocks, kThreads, 0,"
SHARED = "__shared__ float hess[kTri * kThreads];"


def _threads(n):
    def edit(s):
        s = s.replace("constexpr int kThreads = 128;", f"constexpr int kThreads = {n};")
        if n * 78 * 4 > 48 * 1024:  # above 48 KB only as dynamic shared memory
            s = s.replace(SHARED, "extern __shared__ float hess[];").replace(
                LAUNCH,
                "cudaFuncSetAttribute(prox3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,"
                " kTri * kThreads * 4);\n  prox3d_kernel<<<(unsigned)blocks, kThreads,"
                " kTri * kThreads * 4,")
        return s
    return edit


VARIANTS = {  # name: (source edit, extra nvcc flags)
    "as is": (lambda s: s, []),
    "64 threads": (_threads(64), []),
    "256 threads": (_threads(256), []),
    "launch_bounds(128, 1)": (
        lambda s: s.replace("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 1)"), []),
    "passes unrolled": (
        lambda s: s.replace("#pragma unroll 1\n    for (int j = 0; j < 12; ++j)",
                            "#pragma unroll\n    for (int j = 0; j < 12; ++j)"), []),
    "maxrregcount 255": (lambda s: s, ["-maxrregcount=255"]),
}


def build_all():
    jobs = {}
    for i, (name, (edit, flags)) in enumerate(VARIANTS.items()):
        d = os.path.join(OUT, str(i))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC, d)
        src = os.path.join(d, "prox3d.cu")
        with open(src) as f:
            text = edit(f.read())
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(d, "libprox3d.so")
        proc = subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", so, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, so, time.perf_counter())
    libs = {}
    for name, (proc, so, t0) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        lines = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name}: built in {time.perf_counter() - t0:.1f} s; " + "; ".join(lines), flush=True)
        lib = ctypes.CDLL(so)
        lib.mm_prox3d.argtypes, lib.mm_prox3d.restype = P3._SIGNATURES["mm_prox3d"]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("cuda_k4_variants: no CUDA device", file=sys.stderr)
        return 1
    libs = build_all()
    _, _, integ = C.box3d("Shoulder", 0, 40)
    z, dxpu, free, cells = C.prox_inputs(integ)
    n = z.shape[1]
    k = (ctypes.c_float * 18)(*integ.mesh.ehat_np.reshape(-1), *consts(integ.w), integ.prox_tol,
                              P3.K_THIRD, P3.K_G2, P3.K_DGDDET, P3.K_SM2A, P3.K_SM2B)
    ref = None
    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        zo, ih = torch.empty_like(z), torch.empty(n, device=z.device)

        def call(lib=libs[name]):
            rc = lib.mm_prox3d(z.data_ptr(), dxpu.data_ptr(), free.data_ptr(), cells.data_ptr(),
                               zo.data_ptr(), ih.data_ptr(), n, k, integ.prox_max_iters,
                               torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        times[name].append(C.time_kernel(call))
        if ref is None:
            ref = (zo.clone(), ih.clone())
        if not (torch.equal(zo, ref[0]) and torch.equal(ih, ref[1])):
            raise AssertionError(f"{name}: output differs from the unchanged kernel's")
    for name, ts in times.items():
        print(f"{name}: {' and '.join(f'{t:.3f}' for t in ts)} ms, bit-equal to the unchanged kernel")
    return 0


if __name__ == "__main__":
    sys.exit(main())
