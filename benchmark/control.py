"""The control of the comparison: the plain reference put in the program's
place and run one precision lower than the configuration states (float32
for float64), on the cell's own inputs at the cell's own size. Its steps
go through the same comparison (``check.compare``) as a run's, and it has
to come out as not correct; its readings set the upper end of each limit.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

on the machine with the card (the benchmark's own runs never run it). It
prints one JSON line a seed with the numbers compared and the limits.
"""

from __future__ import annotations

import argparse
import json
import math
import random
import sys

import torch

from benchmark import cells, check, inputs
from benchmark.reference.steps import load
from benchmark.window import Sample, Step, Window


def control_window(cell, mesh, x0, seed: int, *, dtype=torch.float32,
                   device="cpu") -> Window:
    """The window that the reference in ``dtype`` would leave: the first
    steps and the sampled step of one trajectory from the seeded start,
    under the same DtTol rule."""
    cfg, chk = cell.cfg, cell.traffic["check"]
    k_first = int(chk["first_steps"])
    j = random.Random(seed).randint(*(int(v) for v in chk["sampled_step"]))
    method = load(cell.traffic["reference"])
    ref = method.build(cfg, mesh, dtype=dtype, device=device)
    x = x0.to(device=device, dtype=dtype)
    state = method.start(ref, x)
    win, ihs, before2, before = Window(), [], x, x
    ih_prev, dt, dt_tol = math.inf, float(cfg["dt"]), float(cfg["DtTol"])
    for i in range(min(int(cfg["nSteps"]), max(k_first, j + 1))):
        state, x_new, ih = method.step(ref, state)
        step = Step(x_new, ih, None)
        if i < k_first:
            win.first.append(step)
        else:
            win.sample = Sample(i, before2, before, step, list(ihs))
        ihs.append(ih)
        before2, before = before, x_new
        win.steps += 1
        if i >= 1 and abs((ih - ih_prev) / dt) < dt_tol:
            break
        ih_prev = ih
    return win


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run the control of a cell's comparison.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    limits = cell.traffic["limits"]
    for seed in args.seeds:
        mesh, x0 = inputs.displaced(cell.cfg, float(cell.traffic["displacement"]), seed, "cuda")
        win = control_window(cell, mesh, x0, seed, device="cuda")
        numbers = check.compare(cell, mesh, x0, win, device="cuda")
        failed = [k for k, v in numbers.items() if not v <= limits[k]]
        print(json.dumps({"workload": cell.name, "seed": seed, "control": "float32",
                          "numbers": numbers, "limits": limits,
                          "fails": failed, "steps": win.steps,
                          "sampled_step": win.sample.index if win.sample else None}),
              flush=True)
        del win, mesh, x0
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
