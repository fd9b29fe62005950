"""The device's idle share of the traced window: 100 (1 - busy / window),
busy the union of the program's device operations inside the window.
Layer: the device."""

from ..trace import busy_us


def read(ctx):
    w0, w1 = ctx.trace.window
    if not ctx.ops or w1 <= w0:
        return None
    return 100.0 * (1.0 - busy_us(ctx.ops, ctx.trace.window) / (w1 - w0))
