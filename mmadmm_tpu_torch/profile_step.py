"""Where a step spends its time on the card, for each path.

    python3 -m mmadmm_tpu_torch.profile_step [--dtype float64] [NAME ...]

For MM-ADMM (method 0), explicit Euler (1) and backward Euler (2) at
Shoulder-320, then 3D MM-ADMM at 3D Shoulder-40 (the identity monitor,
768,000 tet slots) on the 3D stencil engine and at 3D CompSquare-20 (a
computational mesh, 96,000 tets) on the stock engine, 3D CompSquare-40
(768,000 tets) on the stock engine's kernel route (``prox_backend=
"pallas"``: K4') and on its generic route (``"vmap"``), the kernel route
with Newton sweeps at 3D CompSquare-40 (``prox_chord=False``: K4''b) and
with chord sweeps at 3D SquareGrid-40 (``prox_chord=True``, a box mesh:
K4''a; a run's ``prox_chord`` goes to ``build_problem``), then Monitor3320r
as a user loads it (float64, the generic prox with the carried Jacobian),
in turn (or only the runs whose names contain one of the NAMEs), the
generated meshes in ``--dtype`` (float32 by default; in float64 the
stencil engines and the kernel route run their kernels built in float64,
and CompSquare-20 takes the generic route, the float64 default): runs 5
steps, then traces 5 more with ``torch.profiler`` (CPU and CUDA
activities) and prints wall ms per step (host clock, ending in
``torch.cuda.synchronize()``), the device's busy share (the sum of kernel
times over the wall time; kernels do not overlap on the one stream the
port uses), the time of each of the port's kernels (K1 ``prox2d``, K2
``eg2d``, K3 ``hess2d``, K4 and K4''b, the instantiations of
``prox3d_newton_kernel``, and K4' and K4''a, of ``prox3d_chord_kernel``;
each in the run's dtype, with its share of the device time), the number
of kernel launches per step, and the
kernels with the most device time. On the generic route it also prints
the device time and launches of the prox's Jacobian builds
(``ElementKernels.masked_jac``) and of its LDL^T solves
(``ops/linalg.py::ldlt_solve``), the ``record_function`` ranges of
``ops/prox.py``. Then explicit (method 1) and backward (method 2) Euler on
the compact path (``ops/compact_eg.py``, no kernel) at 3D Shoulder-40 and
3D SquareGrid-40 (``--dtype``), and backward Euler at Monitor3320r as
loaded, each with the device time and launches of the compact path's
ranges: the ``(Ih, grad)`` evaluations, the element-Hessian builds and
the matvec products. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import ExperimentConfig, build_problem, load_experiment_config
from .ops import compact_eg, prox

# the traced ranges: the generic prox's and the compact Euler path's
RANGES = prox.RANGES + compact_eg.RANGES

WARM = 5
STEPS = 5
# kernel: the name its device time is found by, after the real type
KERNELS = {"prox2d": "prox2d_kernel<", "eg2d": "eg2d_kernel<", "hess2d": "hess2d_kernel<",
           "K4": "prox3d_newton_kernel<{}, false,", "K4'": "prox3d_chord_kernel<{}, true,",
           "K4''a": "prox3d_chord_kernel<{}, false,", "K4''b": "prox3d_newton_kernel<{}, true,"}
_REAL = {"float32": "float", "float64": "double"}
M3320R = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "Experiments", "InputFiles", "Monitor3320r.json")
_2D = dict(test_type="Shoulder", dim=2, mon_type=1, nx=320, ny=320)
_COMP3 = dict(test_type="SquareGrid", dim=3, mon_type=5, method=0, comp_mesh=True, nx=20, ny=20,
              nz=20, rho=10.0)
RUNS = {
    "MM-ADMM": dict(_2D, method=0),
    "explicit Euler": dict(_2D, method=1),
    "backward Euler": dict(_2D, method=2),
    "3D MM-ADMM, 3D Shoulder-40": dict(test_type="Shoulder", dim=3, mon_type=0, method=0,
                                       nx=40, ny=40, nz=40),
    "3D MM-ADMM stock, 3D CompSquare-20": _COMP3,
    "3D MM-ADMM stock, 3D CompSquare-40, kernel route": dict(_COMP3, nx=40, ny=40, nz=40,
                                                             prox_backend="pallas"),
    "3D MM-ADMM stock, 3D CompSquare-40, generic route": dict(_COMP3, nx=40, ny=40, nz=40,
                                                              prox_backend="vmap"),
    "3D MM-ADMM stock, 3D CompSquare-40, Newton sweeps": dict(_COMP3, nx=40, ny=40, nz=40,
                                                              prox_backend="pallas",
                                                              prox_chord=False),
    "3D MM-ADMM stock, 3D SquareGrid-40, chord sweeps": dict(
        test_type="SquareGrid", dim=3, mon_type=1, method=0, nx=40, ny=40, nz=40,
        prox_backend="pallas", prox_chord=True),
    "Monitor3320r float64 (generic route)": M3320R,
    # explicit and backward Euler on the compact path (no kernel)
    "3D explicit Euler, 3D Shoulder-40": dict(test_type="Shoulder", dim=3, mon_type=0, method=1,
                                              nx=40, ny=40, nz=40),
    "3D backward Euler, 3D Shoulder-40": dict(test_type="Shoulder", dim=3, mon_type=0, method=2,
                                              nx=40, ny=40, nz=40),
    "3D explicit Euler, 3D SquareGrid-40": dict(test_type="SquareGrid", dim=3, mon_type=1,
                                                method=1, nx=40, ny=40, nz=40),
    "3D backward Euler, 3D SquareGrid-40": dict(test_type="SquareGrid", dim=3, mon_type=1,
                                                method=2, nx=40, ny=40, nz=40),
    "backward Euler, Monitor3320r float64 (compact path)": (M3320R, 2),
}


def profile_run(name: str, dtype: str = "float32") -> None:
    chord = None
    if isinstance(RUNS[name], str):
        cfg = load_experiment_config(RUNS[name])
    elif isinstance(RUNS[name], tuple):
        cfg = load_experiment_config(*RUNS[name])
    else:
        kw = dict(RUNS[name])
        chord = kw.pop("prox_chord", None)
        cfg = ExperimentConfig(**dict(dict(dt=5e-3, tau=0.1, rho=50.0, dtype=dtype), **kw))
    mesh, integ = build_problem(cfg, prox_chord=chord)
    state = integ.init_state()
    for _ in range(WARM):
        state, _ = integ.step(state)
    torch.cuda.synchronize()
    infos = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, info = integ.step(state)
            infos.append(info)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    averages = prof.key_averages()
    # device events, without the ranges' own device-side annotations
    kernels = [e for e in averages if e.device_type.name == "CUDA" and e.key not in RANGES]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    inner = "".join(f", {f} {[getattr(i, f) for i in infos]}" for f in ("n_iters", "n_newton")
                    if hasattr(infos[0], f))
    print(f"{name}, {cfg.dtype}, {type(integ).__name__}, prox {mesh.prox_backend} on "
          f"{torch.cuda.get_device_name(0)}: "
          f"{STEPS} traced steps after {WARM}{inner}")

    def kernel_ms(key):
        us = sum(e.self_device_time_total for e in kernels if key in e.key)
        return 1e-3 * us / STEPS

    busy_ms = 1e-3 * dev_us / STEPS

    def share(ms):
        return f" ({100 * ms / busy_ms:.1f} % of device)" if ms and busy_ms else ""

    per_kernel = "; ".join(f"{k} {ms:.3f} ms/step{share(ms)}" for k, ms in (
        (k, kernel_ms(key.format(_REAL[cfg.dtype]))) for k, key in KERNELS.items()))
    print(f"wall {wall_ms / STEPS:.3f} ms/step (traced); device busy "
          f"{busy_ms:.3f} ms/step = {100 * busy_ms * STEPS / wall_ms:.1f} % of wall; "
          f"{per_kernel}; {launches / STEPS:.0f} kernel launches/step")
    compact = type(getattr(integ, "eg", None)) is compact_eg.CompactEG
    if compact or (cfg.method == 0 and mesh.prox_backend == "vmap"):
        # each range's device time and launches: those of the kernels
        # launched under it
        events = prof.events()
        for r in compact_eg.RANGES if compact else prox.RANGES:
            spans = [e for e in events if e.name == r and e.device_type.name == "CPU"]
            us, n = map(sum, zip(*(_kernels(e) for e in spans))) if spans else (0, 0)
            print(f"  range {r}: {len(spans) / STEPS:.1f} calls/step, device "
                  f"{1e-3 * us / STEPS:.3f} ms/step, {n / STEPS:.0f} kernel launches/step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {1e-3 * e.self_device_time_total / STEPS:8.3f} ms/step "
              f"{e.count / STEPS:6.1f} launches/step  {e.key[:90]}")


def _kernels(event):
    """``(device us, launches)`` of the kernels launched under a profiler
    event and its children (not the ranges' device-side annotations)."""
    own = [k for k in event.kernels if k.name not in RANGES]
    us, n = sum(k.duration for k in own), len(own)
    for c in event.cpu_children:
        cu, cn = _kernels(c)
        us, n = us + cu, n + cn
    return us, n


def main() -> None:
    ap = argparse.ArgumentParser(description="Trace a few steps of each path on the card.")
    ap.add_argument("names", nargs="*", help="run only the paths whose names contain one")
    ap.add_argument("--dtype", choices=sorted(_REAL), default="float32",
                    help="the generated meshes' dtype (Monitor3320r runs as loaded)")
    args = ap.parse_args()
    for name in RUNS:
        if not args.names or any(a in name for a in args.names):
            profile_run(name, args.dtype)


if __name__ == "__main__":
    main()
