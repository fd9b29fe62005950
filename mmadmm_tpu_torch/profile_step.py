"""Where a Shoulder-320 MM-ADMM step spends its time on the card.

    python3 -m mmadmm_tpu_torch.profile_step

Runs 5 steps of Shoulder-320, then traces 5 more with
``torch.profiler`` (CPU and CUDA activities) and prints: wall ms per step
(host clock, ending in ``torch.cuda.synchronize()``), the device's busy
share (the sum of kernel times over the wall time; kernels do not overlap
on the one stream the port uses), K1's share, the number of kernel
launches per step, and the kernels with the most device time. Needs a
CUDA card.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import ExperimentConfig, build_problem

WARM = 5
STEPS = 5


def main() -> None:
    cfg = ExperimentConfig(test_type="Shoulder", dim=2, mon_type=1, method=0, nx=320,
                           ny=320, dt=5e-3, tau=0.1, rho=50.0, dtype="float32")
    _, integ = build_problem(cfg)
    state = integ.init_state()
    for _ in range(WARM):
        state, _ = integ.step(state)
    torch.cuda.synchronize()
    iters = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, info = integ.step(state)
            iters += info.n_iters
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    k1_us = sum(e.self_device_time_total for e in kernels if "prox2d" in e.key)
    name = torch.cuda.get_device_name(0)
    print(f"{name}: {STEPS} traced steps after {WARM}, {iters} ADMM iterations")
    print(f"wall {wall_ms / STEPS:.3f} ms/step (traced); device busy "
          f"{1e-3 * dev_us / STEPS:.3f} ms/step = {100 * 1e-3 * dev_us / wall_ms:.1f} % of wall; "
          f"K1 {1e-3 * k1_us / STEPS:.3f} ms/step; {launches / STEPS:.0f} kernel launches/step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {1e-3 * e.self_device_time_total / STEPS:8.3f} ms/step "
              f"{e.count / STEPS:6.1f} launches/step  {e.key[:90]}")


if __name__ == "__main__":
    main()
