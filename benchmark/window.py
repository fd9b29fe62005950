"""The system under test and the timed window.

Set-up builds the program as its CLI does (``load_experiment_config``,
the traffic's method, ``build_problem``), asserts the engine the cell
names, puts the seeded positions into the state that ``init_state()``
returns (the program has no argument for them) and warms up with one step
from that state.

The window runs trajectories back to back. Each starts from the seeded
state and calls ``integ.step(state)`` until the runner's DtTol rule
(``harness/runner.py``: ``|I_h - I_h prev| / dt < DtTol`` from the second
step on) or the configuration's ``nSteps`` ends it; then the next one
starts. The window closes with the first step that completes after the
asked seconds. Each step's positions are copied aside (under the
``bench.keep`` range, which the trace readings leave out), so that the
check after the window judges what the timed path produced:

* the first ``first_steps`` steps of the latest trajectory that made them
  (the check follows them from the seeded start), and
* one later step, the trajectory's step ``j`` drawn from the seed in
  ``sampled_step`` (or the trajectory's last, where it ends sooner), with
  the positions of the two steps before it and the I_h of every step
  before it in its trajectory.
"""

from __future__ import annotations

import importlib
import math
import random
import time
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function

KEEP_RANGE = "bench.keep"


@dataclass
class Step:
    x: torch.Tensor  # positions [NP, 3] after the step (a copy)
    ih: float
    n_iters: int | None


@dataclass
class Sample:
    index: int  # the step's index in its trajectory
    before2: torch.Tensor  # positions after step index-2 (the start for index 1)
    before: torch.Tensor  # positions after step index-1
    step: Step
    ihs: list  # I_h of steps 0 .. index-1


@dataclass
class Window:
    seconds: float = 0.0
    steps: int = 0
    trajectories: int = 0
    failed: int = 0
    lengths: list = field(default_factory=list)  # steps of each trajectory that ended
    infos: list = field(default_factory=list)  # (I_h, ADMM iterations or None) of every step
    first: list = field(default_factory=list)  # Step of the first steps
    sample: Sample | None = None


def _resolve(root, path: str):
    obj = root
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def counter(spec: str):
    """The value of a launch counter ``"module:attr.attr"``."""
    mod, attr = spec.split(":")
    return _resolve(importlib.import_module(mod), attr)


def build(cell, device):
    """``(cfg, mesh, integ)``: the program on ``device`` as its CLI builds
    it, with the engine the traffic names asserted and printed."""
    import mmadmm_tpu_torch as program

    cfg = program.load_experiment_config(cell.config_path, method=cell.traffic["method"])
    mesh, integ = program.build_problem(cfg, device=device)
    found = {"integ": type(integ).__name__}
    ns = {"integ": integ, "mesh": mesh}
    for path, want in cell.traffic["engine"].items():
        head, _, rest = path.partition(".")
        obj = _resolve(ns[head], rest) if rest else ns[head]
        got = str(obj) if path.endswith("dtype") else type(obj).__name__
        found[path] = got
        if got != want:
            raise RuntimeError(f"{cell.name}: {path} is {got}, the cell measures {want}")
    return cfg, mesh, integ, found


def seeded_state(integ, x0: torch.Tensor):
    """``init_state()`` with the positions ``x0 [NP, 3]`` put in the field
    that ``harness.runner.positions`` reads (channel-major on the 3D
    stencil engine)."""
    from mmadmm_tpu_torch.harness.runner import positions

    s = integ.init_state()
    p = positions(s)
    if p.shape != x0.shape:
        raise RuntimeError(f"the state holds positions {tuple(p.shape)}, not {tuple(x0.shape)}")
    x = x0 if s.x.shape == p.shape else x0.T.contiguous()
    return s._replace(x=x, x_prev=x)


def warm_up(cell, integ, x0):
    """One step from the seeded state; on the card, where the traffic names
    a launch counter, the launches it counted must equal the step's count
    it names (K4's float64 launches and the ADMM iterations). On a CPU the
    kernels' plain versions run and count nothing."""
    spec = cell.traffic.get("launches") if x0.is_cuda else None
    before = counter(spec["counter"]) if spec else 0
    _, info = integ.step(seeded_state(integ, x0))
    if x0.is_cuda:
        torch.cuda.synchronize()
    if spec:
        made, want = counter(spec["counter"]) - before, getattr(info, spec["equals"])
        if made != want:
            raise RuntimeError(f"{cell.name}: {spec['counter']} counted {made} launches in a "
                               f"step of {spec['equals']} {want}")
        return f"{spec['counter']} {made} = {spec['equals']} {want}"
    return None


def run(cell, integ, x0, seconds: float, seed: int, dt: float, dt_tol: float,
        n_steps: int) -> Window:
    """The timed window (see the module's docstring)."""
    from mmadmm_tpu_torch.harness.runner import positions

    chk = cell.traffic["check"]
    k_first = int(chk["first_steps"])
    lo, hi = chk["sampled_step"]
    j = random.Random(seed).randint(int(lo), int(hi))
    sync = torch.cuda.synchronize if x0.is_cuda else (lambda: None)
    win = Window()

    def keep(state):
        with record_function(KEEP_RANGE):
            return positions(state).clone()

    start = x0.clone()
    sync()
    t0 = time.perf_counter()
    closed = False
    while not closed:
        state = seeded_state(integ, x0)
        win.trajectories += 1
        first, ihs, last, sampled = [], [], None, False
        before2 = before = start
        ih_prev, i = math.inf, 0
        while i < n_steps:
            state, info = integ.step(state)
            ih = float(info.ih)
            step = Step(keep(state), ih, getattr(info, "n_iters", None))
            win.steps += 1
            win.infos.append((ih, step.n_iters))
            if i < k_first:
                first.append(step)
                if i == k_first - 1:
                    win.first = first
            else:
                last = Sample(i, before2, before, step, list(ihs))
                if i == j:
                    win.sample, sampled = last, True
            ihs.append(ih)
            before2, before = before, step.x
            i += 1
            finite = math.isfinite(ih)
            if not finite:
                win.failed += 1
            done = not finite or (i > 1 and abs((ih - ih_prev) / dt) < dt_tol)
            ih_prev = ih
            if time.perf_counter() - t0 >= seconds:
                closed = True
            if done or closed:
                break
        if not closed or done or i == n_steps:
            win.lengths.append(i)
        if len(first) < k_first and (not win.first or not closed):
            win.first = first or win.first
        if last is not None and not sampled and (win.sample is None or not closed):
            win.sample = last
    sync()
    win.seconds = time.perf_counter() - t0
    return win
