"""Whole trajectories of a cell, one start at a time: where the runner's
DtTol rule would stop each and what each step costs, for a range of
seeded displacements. The traffic's ``displacement`` is chosen from this.

    python3 -m benchmark.trajectories --workload 3DMonitor280.admm \
        --fractions 0 0.001 0.04 --seeds 1 2 --steps 100

on the machine with the card. Each trajectory runs ``--steps`` steps
whatever the DtTol rule says, and prints one JSON line: the step the rule
stops at (``stop``, the number of steps taken, or None), the I_h and
ADMM iterations of every step, and the mean host-clock time of a step up
to the stop and over all the steps. A fraction of 0 is the undisplaced
mesh, run once whatever the seeds.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from benchmark import cells, inputs, window


def trajectory(integ, x0, steps: int, dt: float, dt_tol: float) -> dict:
    state = window.seeded_state(integ, x0)
    ihs, iters, times, stop, ih_prev = [], [], [], None, math.inf
    for i in range(steps):
        t0 = time.perf_counter()
        state, info = integ.step(state)
        ih = float(info.ih)
        times.append(time.perf_counter() - t0)
        ihs.append(ih)
        iters.append(getattr(info, "n_iters", None))
        if stop is None and i >= 1 and abs((ih - ih_prev) / dt) < dt_tol:
            stop = i + 1
        ih_prev = ih
    k = stop or steps
    return {"stop": stop, "ms_to_stop": 1e3 * sum(times[:k]) / k,
            "ms_all": 1e3 * sum(times) / len(times), "ih": ihs, "iters": iters}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Whole trajectories of a cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fractions", type=float, nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    dev = "cuda"
    cfg, mesh, integ, found = window.build(cell, dev)
    _, x0 = inputs.displaced(cell.cfg, 0.0, 0, dev)
    integ.step(window.seeded_state(integ, x0.to(mesh.dtype)))  # warm-up
    print(f"{cell.name}: engine {found}", flush=True)
    for frac in args.fractions:
        for seed in args.seeds[:1] if frac == 0 else args.seeds:
            _, x0 = inputs.displaced(cell.cfg, frac, seed, dev)
            out = trajectory(integ, x0.to(mesh.dtype), args.steps, cfg.dt, cfg.dt_tol)
            print(json.dumps({"workload": cell.name, "fraction": frac, "seed": seed,
                              "dt_tol": cfg.dt_tol, **out}), flush=True)
            del x0
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
