"""K4's share of its roofline, in %: the bound of the sampled K4 launches
over their device time. Layer: kernel K4 (``ops/prox3d.py::prox3d``,
float64, ``prox3d_newton_kernel<double, false,``).

In the traced run ``install`` wraps the name ``prox3d`` that the 3D
stencil engine calls (``integrators/admm_soa.py``). Every ``EVERY``-th
launch of the window, up to ``MAX_SAMPLES`` of them, it keeps a strided
sample of about ``COLUMNS`` of the launch's input columns, taken from the
columns with a movable vertex (the carve's dead slots have none), under
the ``bench.k4_sample`` range that the trace readings leave out. After
the window each sample's operations are counted on the frozen plain K4
(``kernels/k4.py``) and scaled by the movable columns over the sampled
ones; the bytes are those of the whole launch. The share is the sum of
the sampled launches' bounds over the sum of their device times, each
launch's time the kernel event of the same launch in the trace (the
kernels in launch order). Nothing is read if the launches and the kernel
events do not pair up.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..kernels.k4 import bound_s, count_ops

KERNEL = "prox3d_newton_kernel<double, false,"
EVERY = 4
MAX_SAMPLES = 16
COLUMNS = 4096
SAMPLE_RANGE = "bench.k4_sample"


def install(ctx):
    import mmadmm_tpu_torch.integrators.admm_soa as engine

    state = ctx.store.setdefault("k4", {"calls": 0, "samples": [], "cols": None})
    original = engine.prox3d

    def prox3d(z, dxpu, free, cells, ehat, w, tol, max_iters):
        if state["calls"] % EVERY == 0 and len(state["samples"]) < MAX_SAMPLES:
            with record_function(SAMPLE_RANGE):
                if state["cols"] is None:
                    live = torch.nonzero(free.abs().sum(0) > 0).reshape(-1)
                    stride = max(1, live.numel() // COLUMNS)
                    state["cols"] = (live[::stride], live.numel())
                cols, n_live = state["cols"]
                state["samples"].append(dict(
                    index=state["calls"], n_slots=z.shape[1], n_live=n_live,
                    inputs=[t.index_select(1, cols) for t in (z, dxpu, free, cells)],
                    args=(ehat, w, tol, max_iters)))
        state["calls"] += 1
        return original(z, dxpu, free, cells, ehat, w, tol, max_iters)

    engine.prox3d = prox3d
    state["restore"] = lambda: setattr(engine, "prox3d", original)


def uninstall(ctx):
    ctx.store["k4"]["restore"]()


def read(ctx):
    state = ctx.store.get("k4")
    if not state or not state["samples"]:
        return None
    events = [o for o in ctx.ops if o.kind == "kernel" and KERNEL in o.name]
    if len(events) != state["calls"]:
        return None
    bound = took = 0.0
    for s in state["samples"]:
        ins = s["inputs"]
        ops = count_ops(*ins, *s["args"]) * s["n_live"] / ins[0].shape[1]
        bound += bound_s(ops, s["n_slots"], ins[0].dtype)
        ev = events[s["index"]]
        took += (ev.end - ev.start) / 1e6
    return 100.0 * bound / took
