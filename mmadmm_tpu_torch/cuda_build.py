"""Build and load the port's CUDA kernels.

A source ``csrc/<name>.cu`` exports plain C functions. It is compiled by
``nvcc`` into ``_build/lib<name>-<hash>.so`` (the hash covers the source,
every ``csrc/`` header it includes and the flags, so an edited source or
header builds anew) at first use and loaded with ``ctypes``. ``build``
starts one ``nvcc`` per source, all at once. ``nvcc -Xptxas -v`` output
(registers and spills per kernel) is kept beside the library as
``<name>-<hash>.ptxas.txt``.

No PyTorch headers are compiled: a source with ``torch/extension.h`` takes
minutes to build, a plain C interface seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and every ``csrc/`` file it includes, directly
    or through another include."""
    todo, seen = [f"{name}.cu"], []
    while todo:
        rel = todo.pop()
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(CSRC, rel), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return seen


def _paths(name: str):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in sorted(_sources(name)):
        with open(os.path.join(CSRC, rel), "rb") as f:
            h.update(rel.encode() + b"\0" + f.read())
    h = h.hexdigest()[:16]
    return (os.path.join(BUILD_DIR, f"lib{name}-{h}.so"),
            os.path.join(BUILD_DIR, f"{name}-{h}.ptxas.txt"))


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines of the current build of ``name``."""
    _, log = _paths(name)
    with open(log) as f:
        return "".join(
            line for line in f if "ptxas info" in line or "bytes spill" in line
        )


def build(names) -> None:
    """Build every ``csrc/<name>.cu`` of ``names`` that has no current
    library yet, one ``nvcc`` process per source, all started together.
    Raises with the compiler's output if a build fails."""
    jobs = []
    for name in names:
        so, log = _paths(name)
        if os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((name, so, log, tmp, proc))
    failed = []
    for name, so, log, tmp, proc in jobs:
        out, _ = proc.communicate()
        with open(log, "w") as f:
            f.write(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each C function to ``(argtypes, restype)``."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(_paths(name)[0])
    for fn, (argtypes, restype) in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = restype
    _loaded[name] = lib
    return lib
