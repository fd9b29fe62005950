"""Experiment runner: the outer time loop with trace and artifact logging
(port of ``mmadmm_tpu/harness/runner.py``; reference ``runAlgo<D>``,
``main.cpp:142-255``):

* run the chosen integrator for ``nSteps`` outer steps,
* record ``(wall seconds, Ih)`` per step, the column format of the
  reference's recorded baselines (``Results/<cfg>/Ih<m>.txt``, written at
  ``main.cpp:238-248``),
* stop early when ``|Ih - IhPrev| / dt < DtTol`` (``main.cpp:200-208``),
* write ``points.txt``, ``triangles.txt``, ``mask.txt``, ``Ih<method>.txt``
  and ``summary.json`` into the output directory (``main.cpp:227-248``),
* report the set-up, first-step and loop wall times (the reference's
  proxTime/predTime counters, ``MeshIntegrator.h:24-27``).

The first step runs once before the loop and is thrown away: its time is
``compile_time``, which here pays the kernels' build and load and the
first ``torch.func`` call. Checkpoint and resume go through
``harness.checkpoint``. The JAX package's ``step_chunk`` (several steps in
one ``lax.scan`` program, a TPU dispatch workaround) has no counterpart:
every step here already reads its energy on the host.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import ExperimentConfig
from ..geometry import io as mesh_io
from ..integrators.admm_soa import SoA3DState
from ..problems import build_problem


@dataclass
class RunResult:
    name: str
    method: int
    ih_trace: list = field(default_factory=list)
    t_trace: list = field(default_factory=list)
    n_steps: int = 0
    converged: bool = False
    failed: bool = False  # non-finite energy watchdog tripped
    setup_time: float = 0.0
    compile_time: float = 0.0
    loop_time: float = 0.0
    final_ih: float = float("nan")
    n_elements: int = 0

    def summary(self) -> dict:
        return {
            "name": self.name,
            "method": self.method,
            "n_steps": self.n_steps,
            "converged": self.converged,
            "failed": self.failed,
            "final_ih": self.final_ih,
            "setup_time": self.setup_time,
            "compile_time": self.compile_time,
            "loop_time": self.loop_time,
        }


def positions(state) -> torch.Tensor:
    """The node positions ``[NP, D]`` of an integrator's state (the 3D
    stencil engine keeps them channel-major, ``[3, NP]``)."""
    return state.x.T if isinstance(state, SoA3DState) else state.x


def run_experiment(
    cfg: ExperimentConfig,
    out_dir: str | None = None,
    base_dir: str | None = None,
    verbose: bool = False,
    checkpoint_every: int = 0,
    resume_from: str | None = None,
    device=None,
) -> RunResult:
    """Build the problem on ``device`` (the card unless the caller asks for
    the CPU) and run it to convergence; optionally write the
    reference-format artifacts into ``out_dir``. ``base_dir`` overrides
    the config's root for FromFile paths.

    ``resume_from``: the path of a ``harness.checkpoint`` file; the run
    picks up that checkpoint's config, integrator state, outer step index
    and DtTol comparator instead of starting fresh."""
    t0 = time.perf_counter()
    start_step, ih_prev0 = 0, math.inf
    if resume_from is not None:
        from .checkpoint import checkpoint_meta, resume_experiment

        cfg, mesh, integ, state = resume_experiment(resume_from, base_dir, device=device)
        start_step, ih_prev0 = checkpoint_meta(resume_from)
    else:
        if base_dir is not None:
            cfg = dataclasses.replace(cfg, base_dir=base_dir)
        mesh, integ = build_problem(cfg, device)
        state = integ.init_state()
    res = RunResult(name=cfg.name, method=cfg.method)
    res.setup_time = time.perf_counter() - t0
    res.n_elements = int(mesh.n_elements)

    # the first step, thrown away (counted apart, like the reference's
    # set-up timers against the per-step wall clock)
    t0 = time.perf_counter()
    ih0 = float(mesh.energy(positions(state)))
    first, _ = integ.step(state)
    if first.x.is_cuda:
        torch.cuda.synchronize(first.x.device)
    del first
    res.compile_time = time.perf_counter() - t0

    # the trace starts with the initial energy row (main.cpp:176-178)
    res.ih_trace = [ih0]
    res.t_trace = [0.0]
    ih_prev = ih_prev0
    t_loop = time.perf_counter()
    step_i = start_step
    ckpt_dir = os.path.join(out_dir, "checkpoints") if out_dir else None
    while step_i < cfg.n_steps:
        state, info = integ.step(state)
        ih = float(info.ih)
        now = time.perf_counter() - t_loop
        step_i += 1
        res.ih_trace.append(ih)
        res.t_trace.append(now)
        # failure watchdog (the reference's failure handling is
        # assert/exit(1), SURVEY §5.3; here: stop, keep artifacts)
        if not math.isfinite(ih):
            res.failed = True
            print(f"[{cfg.name}] non-finite energy at step ~{step_i - 1}; stopping", flush=True)
            break
        # |dIh/dt| < DtTol stop (main.cpp:200-208)
        done = step_i > 1 and abs((ih - ih_prev) / cfg.dt) < cfg.dt_tol
        ih_prev = ih
        if verbose:
            print(f"step {step_i}: Ih={ih:.8g}", flush=True)
        if checkpoint_every and ckpt_dir and step_i % checkpoint_every == 0:
            from .checkpoint import save_checkpoint

            save_checkpoint(ckpt_dir, cfg, mesh, state, step_i, ih_prev)
        if done:
            res.converged = True
            break
    res.loop_time = time.perf_counter() - t_loop
    res.n_steps = step_i
    res.final_ih = res.ih_trace[-1]

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        x_final = positions(state).detach().cpu().numpy().astype(np.float64)
        mesh_io.write_points(os.path.join(out_dir, "points.txt"), x_final)
        mesh_io.write_triangles(os.path.join(out_dir, "triangles.txt"), mesh._F_np)
        mesh_io.write_mask(os.path.join(out_dir, "mask.txt"), mesh.mask_np)
        mesh_io.write_energy_trace(
            os.path.join(out_dir, f"Ih{cfg.method}.txt"), res.t_trace, res.ih_trace
        )
        with open(os.path.join(out_dir, "summary.json"), "w") as f:
            json.dump(res.summary(), f, indent=2)
    return res
