"""Kernel launches a step: the kernels of the device trace that the
program launched in the window (not the benchmark's own), over the
window's steps. Layer: the inner iteration (``ops/stencil3d.py``,
``ops/monitor_grid.py``, ``ops/compact_eg.py``, ``ops/reductions.py``)."""


def read(ctx):
    kernels = [o for o in ctx.ops if o.kind == "kernel"]
    if not kernels or not ctx.window.steps:
        return None
    return len(kernels) / ctx.window.steps
