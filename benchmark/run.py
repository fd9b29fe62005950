"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up (timed as ``setup_s``, from this module's first statement):
the seeded inputs, the program built as its CLI builds it, the engine
asserted and printed, one warm-up step. Then the window (``window.py``),
traced by ``torch.profiler`` with ``--trace 1``. Then, with the program's
state freed, the per-layer readers (``metrics/``) and the comparison with
the plain reference (``check.py``), whose numbers and limits are the last
lines on standard error and the last key of the result, the last line on
standard output.

With ``--trace 0`` the metrics are the cell's end-to-end ones
(``step_ms``, ``peak_gib``, ``setup_s``); with ``--trace 1`` its per-layer
ones, over a window of at most ``TRACE_SECONDS``, and ``device`` adds
``busy_s`` and ``window_s``. The run exits 2,
printing no result, without a CUDA card or with fewer than the cell asks
for, and 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from benchmark import cells, check, guard, inputs, trace, window  # noqa: E402

# The traced window's length at most: the profiler's trace of a window
# costs up to about seven times its length to collect and read (at some
# 30,000 device operations a second), and the whole run has to end within
# 360 s.
TRACE_SECONDS = 10.0


@dataclass
class Context:
    """What a per-layer reader sees (``metrics/__init__.py``)."""

    cell: cells.Cell
    window: window.Window | None = None
    trace: trace.TraceData | None = None
    ops: list = field(default_factory=list)
    store: dict = field(default_factory=dict)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def end_to_end(win, peak_bytes: int, setup_s: float) -> dict:
    """``step_ms``: the window's wall time over all the steps completed in
    it; ``peak_gib``: the allocator's peak over set-up and window;
    ``setup_s``: process start to the window's start."""
    return {"step_ms": 1e3 * win.seconds / win.steps, "peak_gib": peak_bytes / 2**30,
            "setup_s": setup_s}


def run_cell(cell, seed: int, seconds: float, traced: bool, device="cuda", t_start=T0):
    """One run of ``cell``: ``(result, compared)``, ``compared`` as
    ``{name: (value, limit)}``."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    frac = float(cell.traffic["displacement"])
    mesh, x0 = inputs.displaced(cell.cfg, frac, seed, device)
    cfg, pmesh, integ, found = window.build(cell, device)
    x0p = x0.to(pmesh.dtype)
    warm = window.warm_up(cell, integ, x0p)
    print(f"{cell.name}: engine {found}; {pmesh.n_elements} elements, {pmesh.n_pnts} nodes"
          f"{f'; warm-up step: {warm}' if warm else ''}", flush=True)
    ctx = Context(cell=cell)
    readers = {m["name"]: cells.reader(m["name"]) for m in cell.per_layer} if traced else {}
    for r in readers.values():
        if hasattr(r, "install"):
            r.install(ctx)
    args = (cell, integ, x0p, seconds, seed, cfg.dt, cfg.dt_tol, cfg.n_steps)
    setup_s = time.perf_counter() - t_start
    if traced:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        args = args[:3] + (min(seconds, TRACE_SECONDS),) + args[4:]
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW_RANGE):
                win = window.run(*args)
    else:
        win = window.run(*args)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    t_closed = time.perf_counter()
    for r in readers.values():
        if hasattr(r, "uninstall"):
            r.uninstall(ctx)
    del integ, pmesh, args
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ctx.window = win
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        ctx.trace = trace.from_profiler(prof)
        del prof
        ctx.ops = trace.program_ops(ctx.trace)
        w0, w1 = ctx.trace.window
        dev["busy_s"] = trace.busy_us(ctx.ops, ctx.trace.window) / 1e6
        dev["window_s"] = (w1 - w0) / 1e6
        breakdown = {"device_ops": trace.top_ops(ctx.ops),
                     "idle_gaps": trace.idle_gaps(ctx.ops, ctx.trace)}
        metrics = {}
        for m in cell.per_layer:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = end_to_end(win, peak, setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    t_read = time.perf_counter()
    numbers = check.compare(cell, mesh, x0, win, device=device)
    limits = cell.traffic["limits"]
    compared = {k: (v, limits[k]) for k, v in numbers.items()}
    correct = win.failed == 0 and all(v <= lim for v, lim in compared.values())
    result = {"correct": correct, "attempted": win.steps, "failed": win.failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
        result["card"] = card_line() if cuda else "cpu"
    result["window"] = {"seconds": win.seconds, "steps": win.steps,
                        "trajectories": win.trajectories, "lengths": win.lengths,
                        "sampled_step": win.sample.index if win.sample else None}
    result["phases_s"] = {"setup": setup_s, "window": t_closed - t_start - setup_s,
                          "readers": t_read - t_closed, "check": time.perf_counter() - t_read}
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result, compared


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found {n}", file=sys.stderr)
        return 2
    result, compared = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = guard.forbidden()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, (v, lim) in compared.items():
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
