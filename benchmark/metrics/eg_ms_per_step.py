"""Device ms a step of the compact path's ``(I_h, grad)`` evaluation: the
device time of the kernels launched under the ``record_function`` range
``compact.eg`` (``ops/compact_eg.py``), over the window's steps. Layer:
the compact path."""

from ..trace import under

RANGE = "compact.eg"


def read(ctx):
    ops = under(ctx.ops, ctx.trace, RANGE)
    if not ops or not ctx.window.steps:
        return None
    return sum(o.end - o.start for o in ops) / 1e3 / ctx.window.steps
