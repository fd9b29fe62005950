"""Build and load the port's CUDA kernels.

A source ``csrc/<name>.cu`` exports plain C functions. It is compiled by
``nvcc`` into ``_build/lib<name>-<hash>.so`` (the hash covers the source
and the flags, so an edited source builds anew) at first use and loaded
with ``ctypes``. ``nvcc -Xptxas -v`` output (registers and spills per
kernel) is kept beside the library as ``<name>-<hash>.ptxas.txt``.

No PyTorch headers are compiled: a source with ``torch/extension.h`` takes
minutes to build, a plain C interface seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# --fmad=false: no fused multiply-add contraction, so each float operation
# rounds as it does in the plain PyTorch versions.
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _paths(name: str):
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        src = f.read()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return (os.path.join(BUILD_DIR, f"lib{name}-{h}.so"),
            os.path.join(BUILD_DIR, f"{name}-{h}.ptxas.txt"))


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines of the current build of ``name``."""
    _, log = _paths(name)
    with open(log) as f:
        return "".join(
            line for line in f if "ptxas info" in line or "bytes spill" in line
        )


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each C function to ``(argtypes, restype)``. Raises
    with the compiler's output if the build fails."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    so, log = _paths(name)
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        with open(log, "w") as f:
            f.write(proc.stdout)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for fn, (argtypes, restype) in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = restype
    _loaded[name] = lib
    return lib
