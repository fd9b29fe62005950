"""Profiling and tracing (port of ``mmadmm_tpu/runtime/profiling.py``;
the reference's ``clock()`` phase accumulators, ``MeshIntegrator.h:24-27``,
printed at exit, ``main.cpp:222-223``):

* ``PhaseTimers``: named wall-clock accumulators; a phase given a
  ``fence`` waits for the card (``torch.cuda.synchronize()``) before its
  clock stops, so its time includes the device work it queued;
* ``trace``: a ``torch.profiler`` trace of a block (CPU and, where the
  card is present, CUDA activity), written for TensorBoard.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def _fence(value) -> None:
    """Wait for the card if ``value`` (a tensor, or a tuple, list or dict
    of them) holds a CUDA tensor."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _fence(v)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _fence(v)


class PhaseTimers:
    """Accumulate wall time per named phase; fences device work."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, fence=None):
        """Time the block as ``name``. ``fence``: a tensor (or a function
        returning one) whose device work the phase waits for."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                _fence(fence() if callable(fence) else fence)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name:24s} {self.totals[name]:9.3f} s"
                f"  ({self.counts[name]} calls)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace around a block, written into ``log_dir``
    in TensorBoard's format; yields the profiler (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
