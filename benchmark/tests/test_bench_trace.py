"""The readings' arithmetic on synthetic event lists: the end-to-end
numbers, the device's busy and idle time, the launches, the compact
gradient's device time, the breakdown, and the benchmark's own operations
left out."""

import pytest

from benchmark import run, trace
from benchmark.metrics import eg_ms_per_step, idle_pct, launches_per_step
from benchmark.window import Window


def op(name, a, b, launch, kind="kernel"):
    return trace.DeviceOp(name, a, b, kind, launch)


def data():
    # a window of 100 us: kernels at 10-20 and 15-30 (overlapping), a copy
    # at 50-60, one kernel of the benchmark's own at 70-80 (launched under
    # bench.keep) and one outside the window
    device = [op("k1", 10, 20, 5), op("eg", 15, 30, 12), op("Memcpy DtoH", 50, 60, 40, "memcpy"),
              op("copy", 70, 80, 66), op("late", 120, 130, 110)]
    ranges = [("bench.window", 0, 100), ("compact.eg", 11, 13), ("bench.keep", 65, 67)]
    host = [("aten::mul", 4, 6), ("aten::add", 11, 14), ("aten::item", 39, 45), ("aten::clone", 65, 67)]
    return trace.TraceData(window=(0, 100), device=device, ranges=ranges, host=host)


class Ctx:
    def __init__(self, steps=2):
        self.trace = data()
        self.ops = trace.program_ops(self.trace)
        self.window = Window(steps=steps)


def test_program_ops_leave_out_the_benchmarks_own():
    names = [o.name for o in Ctx().ops]
    assert names == ["k1", "eg", "Memcpy DtoH"]


def test_busy_and_idle():
    ctx = Ctx()
    assert trace.busy_us(ctx.ops, ctx.trace.window) == 30.0  # 10-30 and 50-60
    assert idle_pct.read(ctx) == pytest.approx(70.0)


def test_launches_and_eg():
    ctx = Ctx(steps=2)
    assert launches_per_step.read(ctx) == 1.0  # two kernels, the copy is no launch
    assert eg_ms_per_step.read(ctx) == pytest.approx(15e-3 / 2)  # 15 us under compact.eg
    ctx.trace.ranges = [r for r in ctx.trace.ranges if r[0] != "compact.eg"]
    assert eg_ms_per_step.read(ctx) is None


def test_breakdown():
    ctx = Ctx()
    assert trace.top_ops(ctx.ops)[0] == ["eg", 15e-6]
    gaps = dict(trace.idle_gaps(ctx.ops, ctx.trace))
    # 0-10 before k1 (launched in aten::mul), 30-50 before the copy (aten::item),
    # 60-100 to the window's end
    assert gaps == pytest.approx({"aten::mul": 10e-6, "aten::item": 20e-6, "window end": 40e-6})


def test_end_to_end():
    win = Window(seconds=2.5, steps=10)
    e2e = run.end_to_end(win, 3 * 2**30, 41.5)
    assert e2e == {"step_ms": 250.0, "peak_gib": 3.0, "setup_s": 41.5}


def test_spans():
    s = trace.Spans([(0, 2), (1, 3), (5, 6)])
    assert 2.5 in s and 4 not in s and 5.5 in s and None not in s
