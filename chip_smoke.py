"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives ``mmadmm_tpu_torch`` (never JAX or ``mmadmm_tpu``) on the card:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: kernel K1 from ``csrc/prox2d.cu`` with ``nvcc``, and its
   registers and spills (``-Xptxas -v``);
3. kernel vs plain: kernel K1 (``csrc/prox2d.cu``) against its plain
   PyTorch version on the same inputs, at Shoulder nx=16 and on the
   step-0 inputs of Shoulder-320 (409,600 element slots);
4. main path: Shoulder-320 MM-ADMM through ``problems.build_problem`` and
   ``integrators.run_loop.run``, at most 30 steps with the DtTol stop;
   the energies must be finite and fall, and K1's launch count must equal
   the ADMM iterations;
5. timing: K1 alone (median of 20 launches, CUDA events), the plain
   version once, and K1's bound; one JSON line ``{"kernels": [...]}``.

The last line is ``{"ok": true, "device": {...}}``; any failed check
raises and the script exits non-zero. Without a CUDA device it exits 1
and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

T0 = time.perf_counter()
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
STEP_CAP = 30
MONITOR1320_IH0 = 0.845393  # BASELINE.md:34, the reference's recorded Ih at step 0


def say(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


def shoulder(nx: int):
    from mmadmm_tpu_torch import ExperimentConfig, build_problem

    cfg = ExperimentConfig(
        test_type="Shoulder", dim=2, mon_type=1, method=0, nx=nx, ny=nx,
        dt=5e-3, tau=0.1, rho=50.0, dtype="float32",
    )
    mesh, integ = build_problem(cfg, device="cuda")
    return cfg, mesh, integ


def prox_inputs(integ):
    """The inputs of the first K1 call of step 0."""
    state = integ.init_state()
    _, x, z, u = integ.start(state)
    dxpu = (integ.gather(x) + u).contiguous()
    return z.contiguous(), dxpu, integ.free, integ.cells(z)


def check_close(name, a, b, rtol, atol):
    """|a - b| <= atol + rtol |b| elementwise, NaNs at the same places."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        raise AssertionError(f"{name}: NaN positions differ")
    ok = ~nan_a
    err = (a[ok] - b[ok]).abs()
    bad = err > atol + rtol * b[ok].abs()
    if bool(bad.any()):
        i = int(bad.nonzero()[0])
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol {rtol} atol {atol}; "
            f"first: {float(a[ok][i])} vs {float(b[ok][i])}"
        )
    return float(err.max()) if err.numel() else 0.0


def compare(label, integ):
    """K1 against its plain version on the first prox inputs of step 0.
    Bands of tests/test_prox_pallas2d.py:95-119: ih0 within rtol 2e-5,
    the regularized energies after the solve within rtol 5e-5."""
    from mmadmm_tpu_torch.ops import prox2d as P

    z, dxpu, free, cells = prox_inputs(integ)
    ehat = integ.mesh.ehat_np.reshape(-1)
    args = (ehat, integ.w, integ.prox_tol, integ.prox_max_iters)
    zk, ihk = P.prox2d(z, dxpu, free, cells, *args)
    torch.cuda.synchronize()
    zp, ihp = P.prox2d_plain(z, dxpu, free, cells, *args)
    rows = [[cells[v * 16 + k] for k in range(16)] for v in range(3)]
    half_w2 = P._consts(integ.w)[1]
    e_k = P.energy_c(list(zk), rows, tuple(ehat), list(dxpu), half_w2)[1]
    e_p = P.energy_c(list(zp), rows, tuple(ehat), list(dxpu), half_w2)[1]
    err_ih = check_close(f"{label} ih0", ihk, ihp, 2e-5, 1e-8)
    err_e = check_close(f"{label} regularized energy", e_k, e_p, 5e-5, 1e-7)
    err_z = float((zk - zp).abs().max())
    same = float((zk == zp).all(0).float().mean())
    say(f"{label}: {z.shape[1]} slots; within bands (ih0 rtol 2e-5, energy rtol 5e-5); "
        f"max |ih0 err| {err_ih:.3e}, max |energy err| {err_e:.3e}, max |z' err| {err_z:.3e}, "
        f"bit-equal z' {100 * same:.2f}% of elements")
    return max(err_ih, err_z), (z, dxpu, free, cells)


class _OpCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the elements computed by float arithmetic, comparisons and
    selects (one operation per output element); data movement is not
    counted."""

    OPS = {
        "add", "sub", "rsub", "mul", "div", "neg", "sqrt", "abs", "clamp_min",
        "clamp_max", "where", "gt", "ge", "lt", "le", "eq", "ne", "isfinite",
        "logical_and", "logical_not", "bitwise_and", "bitwise_not", "maximum",
        "reciprocal",
    }

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__.rstrip("_") in self.OPS:
            self.ops += out.numel()
        return out


def time_kernel(fn, n=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mmadmm_tpu_torch import cuda_build
    from mmadmm_tpu_torch.integrators.run_loop import run
    from mmadmm_tpu_torch.ops import prox2d as P

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    say(f"device: {kind}; {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t = time.perf_counter()
    P.library()
    say(f"build: prox2d {time.perf_counter() - t:.2f} s")
    for line in cuda_build.ptxas_report("prox2d").splitlines():
        say(f"ptxas prox2d: {line.strip()}")

    _, _, small = shoulder(16)
    compare("K1 vs plain, Shoulder nx=16", small)
    t = time.perf_counter()
    cfg, mesh, integ = shoulder(320)
    say(f"Shoulder-320 set-up: {mesh.n_pnts} nodes, {mesh.n_elements} live "
        f"triangles, {integ.NFd} slots ({time.perf_counter() - t:.2f} s)")
    max_err, inputs = compare("K1 vs plain, Shoulder-320 step 0", integ)

    # ---- main path ---------------------------------------------------------
    iters = []
    last = [time.perf_counter()]

    def on_step(k, info):
        torch.cuda.synchronize()
        now = time.perf_counter()
        iters.append(info.n_iters)
        say(f"step {k}: ih_start {info.ih_start:.9f} n_iters {info.n_iters} "
            f"primal {info.primal:.3e} dual {info.dual:.3e} "
            f"{1e3 * (now - last[0]):.1f} ms")
        last[0] = now

    state = integ.init_state()
    P.prox2d.launches = 0
    last[0] = time.perf_counter()
    state, trace, steps = run(integ, state, cap=STEP_CAP, dt_tol=cfg.dt_tol, on_step=on_step)
    torch.cuda.synchronize()
    launches = P.prox2d.launches
    ih = trace[:steps]
    say(f"main path: {steps} steps, Ih {ih[0]:.9f} -> {ih[-1]:.9f}; "
        f"K1 launches {launches}, ADMM iterations {sum(iters)}")
    say(f"step-0 Ih {ih[0]:.6f} beside the reference's recorded Monitor1320 "
        f"initial Ih {MONITOR1320_IH0} (information: dt/rho may differ from its JSON)")
    if not all(math.isfinite(v) for v in ih):
        raise AssertionError(f"non-finite energy in {ih}")
    if not ih[-1] < ih[0]:
        raise AssertionError(f"energy did not fall: {ih[0]} -> {ih[-1]}")
    if launches != sum(iters) or launches == 0:
        raise AssertionError(f"K1 launches {launches} != ADMM iterations {sum(iters)}")
    if not bool(torch.isfinite(state.x).all()):
        raise AssertionError("non-finite mesh positions")

    # ---- timing --------------------------------------------------------------
    z, dxpu, free, cells = inputs
    args = (integ.mesh.ehat_np.reshape(-1), integ.w, integ.prox_tol, integ.prox_max_iters)
    ms = time_kernel(lambda: P.prox2d(z, dxpu, free, cells, *args))
    torch.cuda.synchronize()
    t = time.perf_counter()
    P.prox2d_plain(z, dxpu, free, cells, *args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t)
    stats = {}
    with _OpCounter() as counter:
        P.prox2d_plain(z, dxpu, free, cells, *args, stats=stats)
    n = z.shape[1]
    nbytes = 4 * n * (6 + 6 + 6 + 48 + 6 + 1)
    bytes_ms = 1e3 * nbytes / H100_BYTES_PER_S
    ops_ms = 1e3 * counter.ops / H100_F32_OPS_PER_S
    say(f"K1 at {n} slots: {ms:.3f} ms (median of 20); plain {plain_ms:.1f} ms; "
        f"{stats['element_sweeps']} element-sweeps in {stats['sweeps']} sweeps, "
        f"{counter.ops:.4e} operations ({ops_ms:.4f} ms at 67 TFLOP/s), "
        f"{nbytes} bytes ({bytes_ms:.4f} ms at 3.35 TB/s)")
    print(json.dumps({"kernels": [{
        "name": "prox2d",
        "route": "cuda",
        "source": "mmadmm_tpu_torch/csrc/prox2d.cu",
        "replaces": "mmadmm_tpu/ops/prox_pallas2d.py:573",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]}), flush=True)
    say("all phases passed")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
