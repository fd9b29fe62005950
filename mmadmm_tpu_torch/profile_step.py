"""Where a step spends its time on the card, for each path.

    python3 -m mmadmm_tpu_torch.profile_step [NAME ...]

For MM-ADMM (method 0), explicit Euler (1) and backward Euler (2) at
Shoulder-320, then 3D MM-ADMM at 3D Shoulder-40 (the identity monitor,
768,000 tet slots) on the 3D stencil engine and at 3D CompSquare-20 (a
computational mesh, 96,000 tets) on the stock engine, in turn (or only
the runs whose names contain one of the NAMEs): runs 5 steps, then traces
5 more with
``torch.profiler`` (CPU and CUDA activities) and prints wall ms per step
(host clock, ending in ``torch.cuda.synchronize()``), the device's busy
share (the sum of kernel times over the wall time; kernels do not overlap
on the one stream the port uses), the time of each of the port's kernels
(K1 ``prox2d``, K2 ``eg2d``, K3 ``hess2d``, K4 ``prox3d``, K4'
``prox3d_chord_comp``), the number of
kernel launches per step, and the kernels with the most device time.
Needs a CUDA card.
"""

from __future__ import annotations

import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import ExperimentConfig, build_problem

WARM = 5
STEPS = 5
KERNELS = ("prox2d", "eg2d", "hess2d", "prox3d", "prox3d_chord_comp")  # "<name>_kernel"
_2D = dict(test_type="Shoulder", dim=2, mon_type=1, nx=320, ny=320)
RUNS = {
    "MM-ADMM": dict(_2D, method=0),
    "explicit Euler": dict(_2D, method=1),
    "backward Euler": dict(_2D, method=2),
    "3D MM-ADMM, 3D Shoulder-40": dict(test_type="Shoulder", dim=3, mon_type=0, method=0,
                                       nx=40, ny=40, nz=40),
    "3D MM-ADMM stock, 3D CompSquare-20": dict(test_type="SquareGrid", dim=3, mon_type=5,
                                               method=0, comp_mesh=True, nx=20, ny=20, nz=20,
                                               rho=10.0),
}


def profile_run(name: str) -> None:
    cfg = ExperimentConfig(**dict(dict(dt=5e-3, tau=0.1, rho=50.0, dtype="float32"),
                                  **RUNS[name]))
    _, integ = build_problem(cfg)
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
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    inner = "".join(f", {f} {[getattr(i, f) for i in infos]}" for f in ("n_iters", "n_newton")
                    if hasattr(infos[0], f))
    print(f"{name} on {torch.cuda.get_device_name(0)}: {STEPS} traced steps "
          f"after {WARM}{inner}")
    def kernel_ms(name):
        us = sum(e.self_device_time_total for e in kernels if name + "_kernel" in e.key)
        return 1e-3 * us / STEPS

    per_kernel = "; ".join(f"{k} {kernel_ms(k):.3f} ms/step" for k in KERNELS)
    print(f"wall {wall_ms / STEPS:.3f} ms/step (traced); device busy "
          f"{1e-3 * dev_us / STEPS:.3f} ms/step = {100 * 1e-3 * dev_us / wall_ms:.1f} % of wall; "
          f"{per_kernel}; {launches / STEPS:.0f} kernel launches/step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {1e-3 * e.self_device_time_total / STEPS:8.3f} ms/step "
              f"{e.count / STEPS:6.1f} launches/step  {e.key[:90]}")


def main() -> None:
    for name in RUNS:
        if len(sys.argv) < 2 or any(a in name for a in sys.argv[1:]):
            profile_run(name)


if __name__ == "__main__":
    main()
