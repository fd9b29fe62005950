"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives ``mmadmm_tpu_torch`` (never JAX or ``mmadmm_tpu``) on the card:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: kernel K1 (``csrc/prox2d.cu``), kernels K2 and K3
   (``csrc/be2d.cu``) and kernels K4, K4' and K4'' (``csrc/prox3d.cu``),
   each in float and double, one ``nvcc`` per source, started together,
   their registers and spills (``-Xptxas -v``), and the blocks and warps an
   SM holds of each of the eight 3D builds (the CUDA occupancy calculator,
   ``ops/prox3d.py::residency``);
3. kernel vs plain: every kernel against its plain PyTorch version on the
   same inputs: K1-K3 at Shoulder nx=16 and on the step-0 inputs of
   Shoulder-320 (409,600 element slots), K4 at 3D SquareGrid nx=4 and on
   the step-0 inputs of 3D Shoulder-40 and 3D SquareGrid-40 (768,000
   slots each), K4' on the stock engine's step-0 inputs of 3D CompSquare
   nx=4, CompSquare-20 (96,000 tets) and CompSquare-40 (768,000), K1
   through the stock engine's element-major entry on Monitor3320r's
   (265,004 triangles), K4''a and K4''b on the stock engine's step-0
   inputs of 3D SquareGrid and CompSquare at nx=4, nx=20 and, in their
   main paths, nx=40 (768,000 tets); K2, K3, K4, K4' and K4'' bit for
   bit; and the float64 builds of K1, K2 and K3 on the step-0 inputs of
   Shoulder-320 in float64 (K2 and K3 also at Shoulder nx=16), of K4 on
   those of 3D Shoulder-40 and 3D
   SquareGrid-40 in float64, and of K4', K4''a and K4''b on the float64
   kernel route's at nx=4 and (in their paths) at CompSquare-20/-40 and
   SquareGrid-40, each bit for bit;
4. main paths, each through ``problems.build_problem`` and
   ``integrators.run_loop.run`` with the DtTol stop, with every launch
   count set to 0 just before and read just after: at Shoulder-320, at
   most 30 steps, MM-ADMM (method 0; K1 launches = ADMM iterations),
   explicit Euler (method 1; K2 launches = steps) and backward Euler
   (method 2; K3 launches = steps, K2 launches = Newton iterations + 3 per
   step); at 3D Shoulder-40 and 3D SquareGrid-40, at most 20 steps, 3D
   MM-ADMM (K4 launches = ADMM iterations; the ``I_h`` trace and the ADMM
   iterations per step equal ``RECORDED_3D``); on the stock element-major
   engine, 3D CompSquare-20 (at most 30 steps) and CompSquare-40 (at most
   10) on their computational meshes (K4' launches = ADMM iterations; the
   ``I_h`` traces and ADMM counts equal ``RECORDED_3D``) and
   Monitor3320r as shipped, in float32 (at most 20 steps; K1 launches =
   ADMM iterations), each with its step-0 energy within rtol 1e-6 of the
   JAX package's. The energies must be finite and fall. Euler and
   backward Euler at Shoulder nx=16 and 3D MM-ADMM at SquareGrid nx=4 and
   CompSquare nx=4 must also agree with the port's CPU run (plain
   versions, held to the JAX package by tests/test_torch_euler_be.py,
   tests/test_torch_soa3d_*.py and tests/test_torch_admm_stock.py);
   then the generic route (``ops/prox.py``, plain PyTorch, no kernel
   launched), each path with its per-step ms, ``n_iters`` and ``I_h``:
   Monitor3320r as a user loads it (float64, the carried Jacobian; at most
   20 steps; steps 0 and 1 against the JAX package's ``I_h`` and counts),
   3D CompSquare-40 and -20 in float64 (at most 3 and 10 steps; the
   step-0 ``I_h``, and CompSquare-20's step 1 and counts, against the JAX
   package's), the LevelSet circle at nx=320 in float64 (dt 1e-6, at most
   4 steps; ``I_h`` falls at every step; steps 0-3 against the JAX
   package's) and
   a 2D computational mesh, SquareGrid-320, in float32 (at most 10 steps);
   K4''a on 3D SquareGrid-40 with ``prox_chord=True`` and K4''b on 3D
   CompSquare-40 with ``prox_chord=False``, on the stock engine (at most 10
   steps each; launches = ADMM iterations; each path equals its
   ``RECORDED_3D`` trace); the generic route on the
   card against the CPU at 2D SquareGrid nx=8 and 3D CompSquare nx=4 in
   float64 over 4 steps; then the float64 stencil engines, each at most
   ``F64_CAP`` steps with the DtTol stop: Shoulder-320 methods 0, 1 and 2
   and 3D Shoulder-40 and SquareGrid-40 (the stencil engine with float64
   state; the float64 kernels launched as the float32 ones are counted
   there, the float32 counters at 0; ``I_h`` finite and falling; step 0
   against the same configuration's float32 run: the initial energy
   within rtol 1e-6 and, for backward Euler, the post-step energy within
   its neumann band, rtol 1e-5), and card against CPU in float64 at
   Shoulder nx=16 (methods 0-2) and 3D SquareGrid nx=4 (``I_h`` within
   rtol 1e-10, the same inner counts); then the stock engine on the
   float64 kernel route (``prox_backend="pallas"``, ``F64_STOCK``, at most
   ``F64_CAP`` steps each): 3D CompSquare-20 and -40 with K4', 3D
   SquareGrid-40 with ``prox_chord=True`` and K4''a, CompSquare-40 with
   ``prox_chord=False`` and K4''b (the float64 launches = ADMM iterations,
   every other counter 0; ``I_h`` finite and falling; the CompSquare
   paths' step-0 ``I_h`` within rtol 1e-12 of the JAX package's and
   CompSquare-20's step 1 within rtol 1e-7, the ADMM counts printed beside
   the JAX package's), and card against CPU on that route at nx=4 (rtol
   1e-10, the same ADMM counts); then explicit and backward Euler
   (methods 1 and 2) on the compact path (``ops/compact_eg.py``, plain
   PyTorch: every launch count 0): at 3D Shoulder-40, 3D SquareGrid-40
   and 3D CompSquare-40 in float32 (at most ``COMPACT_CAPS`` steps: 20
   and 10) and at Monitor3320r as loaded (float64, at most 10 steps; steps
   0 and 1 within rtol 1e-10 of the JAX package's, the same Newton
   counts), each with its ms per step, Newton counts and peak device
   memory, ``I_h`` finite and falling, and card against CPU at 3D
   SquareGrid nx=4 in float64 (rtol 1e-10, the same Newton counts);
5. timing: each kernel alone as a call of its wrapper (median of 20
   single calls between CUDA events: what a path pays, the wrapper's host
   work included) and as a launch of its bare C entry into the same
   outputs (median of 5 runs of 20 back-to-back launches: its device
   time), its plain version once, and its bound (float64 rows: 8-byte values, the
   float64 operation rate); one JSON line ``{"kernels": [...]}`` (K4' on
   CompSquare-40's step-0 inputs, and on CompSquare-20's on a line of its
   own, in each dtype; K4's bound at 3D SquareGrid-40's step-0 inputs on a
   line of its own, in each dtype); K1's work line at Shoulder-320 step 0
   in each dtype: element-sweeps, Hessian builds and retirements on the gradient,
   the sweeps the carved slots (free all 0) take alone, and the block K1
   launches with (elements, one thread each);
6. the experiment harness (``mmadmm_tpu_torch.harness``, the CLI's code),
   after every earlier phase has handed its memory back, its launches
   added to the kernels line's (K4 float64, K1): the 6.1M-tet
   tier, 3D SquareGrid-80 (MonType 1, 6,144,000 tets) and 3D Shoulder-80
   (MonType 0, 5,376,000 live tets in 6,144,000 slots), dt 5e-3, tau 0.1,
   rho 50, in float64 as a JSON config written by ``make_config_json``
   gives them (DtTol 1e-12, so that every capped step runs), MM-ADMM on
   the 3D stencil engine through ``run_experiment``, 4 steps each: set-up,
   first-step and per-step times, the peak device memory, K4 float64
   launches = ADMM iterations (the runner's thrown-away first step
   included), ``I_h`` finite and falling, the artifacts (``Ih0.txt`` with
   steps + 1 rows); K4 float64 on each one's step-0 inputs over all
   6,144,000 slots bit for bit against its plain version run on slabs of
   768,000 slots, timed (a wrapper call, a bare launch) beside its bound;
   explicit and backward Euler at SquareGrid-80 (the compact path, no
   launch), 3 steps each, with the Newton counts and the peak memory;
   ``Monitor3320r.json`` through the CLI (``mmadmm_tpu_torch.run.main``),
   3 steps, as loaded (float64, the generic route, steps 0 and 1 against
   the JAX package's) and with ``--dtype float32`` (K1 launches = ADMM
   iterations, step 0 against the JAX package's); Shoulder-320 in float32
   for 4 steps against 2 steps, a checkpoint, a resume and 2 more (the
   step-4 state bit-equal);
7. runs over ranks (``mmadmm_tpu_torch.parallel``), two and three
   processes on the one card over gloo (NCCL refuses two ranks on one
   device), each held to the one-card run of the same configuration: the
   dry run's problem (``mmadmm_tpu_torch.dryrun``: 2D SquareGrid nx=22 in
   float64, 3 MM-ADMM steps and one step of each Euler method; ``I_h``
   within 1e-9, equal counts) on 2 and 3 ranks; on 2 ranks, Monitor3320r
   in float32 on the sharded stock engine with K1 (10 steps), 3D
   CompSquare-40 in float64 with K4' (4 steps), explicit and backward
   Euler (``hess``) at Monitor3320r in float64 (2 steps each): on every
   rank K1 and K4' float64 bit-equal to their plain versions on the
   rank's step-0 shard inputs and launched once an ADMM iteration, every
   rank reading the same ``I_h`` bits, ``I_h`` within ``SHARD_RTOL`` of
   the one-card run (rel 1e-5 for float32, 1e-9 for float64) and the
   float64 counts equal; the ranks' ms a step printed beside the one
   card's (two processes sharing a card: no scaling number). Their K1 and
   K4' launches are added to the kernels line, which prints after it.

The last line is ``{"ok": true, "device": {...}}``; any failed check
raises and the script exits non-zero. Without a CUDA device it exits 1
and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import time

import torch

T0 = time.perf_counter()
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
# float64 outside the tensor cores: half the float32 rate (NVIDIA's H100
# SXM data sheet gives 34 TFLOP/s, the Hopper white paper 64 float64 units
# an SM against 128 float32 ones)
H100_F64_OPS_PER_S = 33.5e12
F64_CAP = 10  # steps of each float64 stencil path
STEP_CAP = 30
STEP_CAP_3D = 20
STOCK_CAPS = {"3D CompSquare-20": 30, "3D CompSquare-40": 10, "Monitor3320r": 20}
SMALL_STEPS = 4  # card-vs-CPU checks at nx=16 (2D) and nx=4 (3D)
MONITOR1320_IH0 = 0.845393  # BASELINE.md:34, the reference's recorded Ih at step 0
# The JAX package's step-0 energy of the stock engine's configurations:
# mmadmm_tpu MovingMesh.energy(X0) in float32 (f64 sum), computed once with
# JAX 0.9.0 on the CPU by scripts/stock_jax_gap.py; the step-0 I_h is the
# energy of the initial mesh, so it needs no prox.
JAX_STEP0_IH = {"3D CompSquare-20": 0.2558352160267532, "Monitor3320r": 0.17139660514658317}
GENERIC_CAPS = {"Monitor3320r float64": 20, "3D CompSquare-40 float64": 3,
                "3D CompSquare-20 float64": 10, "LevelSet-320 float64": 4,
                "2D CompSquare-320 float32": 10}
K4PP_CAP = 10
# The float64 kernel-route paths on the stock engine (prox_backend="pallas"
# in float64), F64_CAP steps each: (label, wrapper, the JAX_GENERIC path of
# the same configuration, the steps held to it). Their step-0 I_h is the
# initial mesh's energy, which needs no prox (rtol 1e-12); CompSquare-20's
# step 1, past one prox, within rtol 1e-7 of the JAX package's chord-Jacobian
# prox (measured 9.7e-11 on an H100; at nx=4 the JAX package's own kernel and
# vmap routes part by up to 4.8e-7 over 4 steps, scripts/stock_jax_gap.py).
F64_STOCK = (
    ("3D CompSquare-20 float64 K4'", "prox3d_chord_comp", "3D CompSquare-20 float64", (0, 1)),
    ("3D CompSquare-40 float64 K4'", "prox3d_chord_comp", "3D CompSquare-40 float64", (0,)),
    ("3D SquareGrid-40 float64 K4''a", "prox3d_chord", None, ()),
    ("3D CompSquare-40 float64 K4''b", "prox3d_comp", "3D CompSquare-40 float64", (0,)),
)
F64_STOCK_RTOL = {0: 1e-12, 1: 1e-7}
# The circle's explicit-Euler predictor is stiff at its near-boundary
# slivers: at nx=320 the dt of tests/test_harness.py (1e-4, at nx=12)
# diverges (I_h 1.98 -> 524 at step 1) and 1e-5 rises at step 4; at 1e-6
# I_h falls at every step (scripts/generic_jax_refs.py)
LEVELSET_DT = 1e-6
# The JAX package's values on its default route (float64, the generic vmap
# prox, the carried Jacobian), computed once with JAX 0.9.0 on the CPU by
# scripts/generic_jax_refs.py: {path: {step: (I_h, n_iters or None, rtol)}}
JAX_GENERIC = {
    "Monitor3320r float64": {0: (0.1713965975485735, 5, 1e-12),
                             1: (0.1709758503664461, 3, 1e-9)},
    "3D CompSquare-20 float64": {0: (0.25583523421540666, 3, 1e-12),
                                 1: (0.25577188530396067, 1, 1e-10)},
    "3D CompSquare-40 float64": {0: (0.31256179059890715, None, 1e-12)},
    # steps 1-3 within the float64 band of tests/test_torch_admm_generic.py
    # (rel 1e-10; the port on the CPU is within 2e-16 of these)
    "LevelSet-320 float64": {0: (1.9768249645214393, 10, 1e-12),
                             1: (1.1772788559172092, 10, 1e-10),
                             2: (1.1750669410812833, 10, 1e-10),
                             3: (1.1731141592543588, 10, 1e-10)},
}
# The I_h traces (rounded to 9 digits) and ADMM iterations per step of the
# 3D kernel paths, as the one-thread-per-element design of each kernel gave
# them on an NVIDIA H100 80GB HBM3 (700 W): of the Newton kernels K4 and
# K4''b, and of the chord kernels K4' (stock CompSquare-20 and -40) and
# K4''a. Each kernel is bit-equal to its plain version, so any design of it
# must give these again.
RECORDED_3D = {
    "3D Shoulder-40": (
        [1.673936114, 1.645554105, 1.635251653, 1.625717401, 1.616891697, 1.60872361,
         1.601169516, 1.594191602, 1.587757013, 1.581838851, 1.576410413, 1.571449288,
         1.566935695, 1.562852191, 1.559183389, 1.555915752, 1.553037331, 1.5505377,
         1.548407747, 1.546639599],
        [4, 3, 3, 3, 3, 3, 3, 3] + [1] * 12),
    "3D SquareGrid-40": (
        [0.455565655, 0.455565161, 0.455564945, 0.455564747, 0.455564583, 0.455564439,
         0.455564316, 0.455564213, 0.455564111, 0.455564023, 0.45556395, 0.455563881,
         0.455563822, 0.455563765, 0.455563707, 0.455563673],
        [3] + [1] * 15),
    "K4''b 3D CompSquare-40": (
        [0.312561783, 0.312516397, 0.312493738, 0.312470986, 0.312448149, 0.312425228,
         0.312402218, 0.312379133, 0.312355958, 0.31233272],
        [3] + [1] * 9),
    "3D CompSquare-20": (
        [0.255835207, 0.255771881, 0.255740371, 0.255708735, 0.255676994, 0.255645136,
         0.255613169, 0.255581089, 0.255548908, 0.255516628, 0.255484239, 0.255451747,
         0.255419158, 0.255386476, 0.255353691, 0.255320809, 0.255287833, 0.25525476,
         0.2552216, 0.255188342, 0.255155, 0.255121559, 0.255088036, 0.255054426,
         0.255020725, 0.254986944, 0.254953081, 0.254919131, 0.254885106, 0.254851003],
        [3] + [1] * 29),
    "3D CompSquare-40": (
        [0.312561783, 0.312516397, 0.312493738, 0.312470986, 0.312448149, 0.312425228,
         0.312402218, 0.312379133, 0.312355958, 0.31233272],
        [3] + [1] * 9),
    "K4''a 3D SquareGrid-40": (
        [0.455565655, 0.455565161, 0.455564945, 0.455564748, 0.455564582, 0.455564438,
         0.455564315, 0.455564211, 0.455564109, 0.45556402],
        [3] + [1] * 9),
}
# eg2d launches of one backward-Euler step beyond its Newton iterations:
# the explicit-Euler guess, the residual F0 and the post-step energy
BE_EG_PER_STEP = 3
# explicit (1) and backward (2) Euler on the compact path
# (ops/compact_eg.py, plain PyTorch, no kernel): the step caps of each
# full-width path
COMPACT_CAPS = {1: 20, 2: 10}
# The JAX package's values of Monitor3320r as loaded (float64) on its
# compact path, computed once with JAX 0.9.0 on the CPU by
# scripts/euler_jax_refs.py: {method: {step: (I_h, Newton iterations)}},
# held within the float64 band of tests/test_torch_be_compact.py (rel
# 1e-10; the port on the CPU is within 2e-16 of these) and the same count
JAX_COMPACT_M3320R = {1: {0: (0.1713965975485735, None), 1: (0.17118649805513925, None)},
                      2: {0: (0.1711919565389179, 1), 1: (0.17099507092332503, 1)}}
COMPACT_RTOL = 1e-10
# the experiment harness on the card (harness_phases): the 6.1M-tet tier,
# 3D SquareGrid-80 and Shoulder-80 (3DMonitor280's and 3DMonitor180's
# sizes, README.md:353-357) in float64 as a JSON config gives it, capped at
# TIER_STEPS MM-ADMM and TIER_EULER_STEPS Euler and backward-Euler steps;
# K4's plain version checked on slabs of TIER_SLAB slots (768,000, the 40^3
# paths' size); Monitor3320r through the CLI for TIER_CLI_STEPS steps
TIER_N = 80
TIER_STEPS = 4
TIER_EULER_STEPS = 3
TIER_CLI_STEPS = 3
TIER_DT_TOL = 1e-12  # DtTol: run the capped steps (SquareGrid-80 meets 1e-5 at step 3)
TIER_SLAB = 768_000
SUMMARY_KEYS = {"name", "method", "n_steps", "converged", "failed", "final_ih", "setup_time",
                "compile_time", "loop_time"}


def say(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


def shoulder(nx: int, method: int = 0, device: str = "cuda", dtype: str = "float32"):
    from mmadmm_tpu_torch import ExperimentConfig, build_problem

    cfg = ExperimentConfig(
        test_type="Shoulder", dim=2, mon_type=1, method=method, nx=nx, ny=nx,
        dt=5e-3, tau=0.1, rho=50.0, dtype=dtype,
    )
    mesh, integ = build_problem(cfg, device=device)
    return cfg, mesh, integ


def box3d(test_type: str, mon_type: int, n: int, device: str = "cuda",
          dtype: str = "float32", method: int = 0):
    """3D MM-ADMM (or ``method``) on an n^3 box mesh: Shoulder with the
    identity monitor (a constant grid) or SquareGrid with the radial bump
    (the 48-wide table)."""
    from mmadmm_tpu_torch import ExperimentConfig, build_problem

    cfg = ExperimentConfig(
        test_type=test_type, dim=3, mon_type=mon_type, method=method, nx=n, ny=n, nz=n,
        dt=5e-3, tau=0.1, rho=50.0, dtype=dtype,
    )
    mesh, integ = build_problem(cfg, device=device)
    return cfg, mesh, integ


def comp_square(n: int, device: str = "cuda", dtype: str = "float32", prox_chord=None,
                prox_backend: str = "auto", method: int = 0, group=None):
    """3D MM-ADMM (or ``method``) on the stock engine: an n^3 SquareGrid box
    mesh on its computational mesh, MonType 5, rho 10 (the 3DMonitor3
    family as the JAX package's tests set it,
    tests/test_prox_pallas3d.py:137-143). In float64,
    ``prox_backend="pallas"`` takes the float64 kernels, "auto" the generic
    prox. With ``group``, this rank's part of a run over its ranks."""
    from mmadmm_tpu_torch import ExperimentConfig, build_problem

    cfg = ExperimentConfig(
        test_type="SquareGrid", dim=3, mon_type=5, method=method, comp_mesh=True, nx=n, ny=n,
        nz=n, dt=5e-3, tau=0.1, rho=10.0, dtype=dtype, prox_backend=prox_backend,
    )
    mesh, integ = build_problem(cfg, device=device, prox_chord=prox_chord, group=group)
    return cfg, mesh, integ


def square_chord(n: int, device: str = "cuda", dtype: str = "float32"):
    """3D MM-ADMM on the stock engine with chord sweeps (K4''a): an n^3
    SquareGrid box mesh with the radial bump (MonType 1), on the kernel
    route in either dtype."""
    from mmadmm_tpu_torch import ExperimentConfig, build_problem

    cfg = ExperimentConfig(
        test_type="SquareGrid", dim=3, mon_type=1, method=0, nx=n, ny=n, nz=n,
        dt=5e-3, tau=0.1, rho=50.0, dtype=dtype, prox_backend="pallas",
    )
    mesh, integ = build_problem(cfg, device=device, prox_chord=True)
    return cfg, mesh, integ


def generic(test_type: str, n: int, device: str = "cuda", **kw):
    """MM-ADMM on the generic route: the LevelSet circle (MonType 0, tau
    0.1, rho 50 as tests/test_harness.py:161-164, dt ``LEVELSET_DT``) in
    float64, or a 2D SquareGrid with ``kw`` (a computational mesh: MonType
    5, rho 10)."""
    from mmadmm_tpu_torch import ExperimentConfig, build_problem

    base = dict(dim=2, method=0, nx=n, ny=n, dt=5e-3, tau=0.1, rho=50.0)
    if test_type == "LevelSet":
        base.update(mon_type=0, dt=LEVELSET_DT)
    cfg = ExperimentConfig(test_type=test_type, **dict(base, **kw))
    mesh, integ = build_problem(cfg, device=device)
    return cfg, mesh, integ


def monitor3320r(device: str = "cuda", as_loaded: bool = False, method: int = 0, group=None):
    """``Experiments/InputFiles/Monitor3320r.json`` as shipped: in float32
    on the kernel route, or ``as_loaded`` (float64, the generic route);
    MM-ADMM or ``method``; with ``group``, this rank's part of a run over
    its ranks."""
    import os

    from mmadmm_tpu_torch import build_problem, load_experiment_config

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_experiment_config(os.path.join(here, "Experiments", "InputFiles",
                                              "Monitor3320r.json"), method=method)
    if not as_loaded:
        cfg.dtype = "float32"
    mesh, integ = build_problem(cfg, device=device, group=group)
    return cfg, mesh, integ


def prox_inputs(integ):
    """The inputs of the first prox call (K1 or K4) of step 0."""
    state = integ.init_state()
    _, x, z, u = integ.start(state)
    dxpu = (integ.gather(x) + u).contiguous()
    return z.contiguous(), dxpu, integ.free, integ.cells(z)


def prox_call(integ):
    """``(inputs, args)`` of the first prox call of step 0 of a stencil
    engine: ``prox_inputs`` and ``(ehat, w, tol, max_iters)``."""
    return prox_inputs(integ), (integ.mesh.ehat_np.reshape(-1), integ.w, integ.prox_tol,
                                integ.prox_max_iters)


def stock_inputs(integ, state=None):
    """The stock engine's first prox call of step 0 (or of the step that
    ``state`` starts), as the element-major entry hands it to its kernel:
    ``(z, dxpu, free, cells)`` channel tensors, and on a computational mesh
    also ``ehat_e [9, NF]``."""
    from mmadmm_tpu_torch.ops.monitor_grid import element_cell_rows

    _, x, z, u = integ.start(integ.init_state() if state is None else state)
    dxpu = integ.gather(x) + u
    nf = z.shape[0]

    def ch(a):
        return a.reshape(nf, -1).T.contiguous()

    args = (ch(z), ch(dxpu), ch(integ.free), element_cell_rows(integ.mesh.grid, z))
    if integ.mesh.comp_mesh:
        args += (ch(integ.ehat),)
    return args


def stock_call(integ):
    """``(inputs, args)`` of the stock engine's first prox call of step 0 on
    the kernel route: ``stock_inputs`` and ``([ehat,] w, tol, max_iters)``,
    the constant Ehat only on a box mesh."""
    args = (integ.w, integ.prox_tol, integ.prox_max_iters)
    if not integ.mesh.comp_mesh:
        args = (integ.mesh.ehat_np.reshape(-1),) + args
    return stock_inputs(integ), args


def be_inputs(integ):
    """The inputs of the first K2 call of step 0 of either Euler method:
    ``(z [6, NFd], cells [48, NFd], ehat)``."""
    z = integ.eg.gather(integ.mesh.X0).contiguous()
    return z, integ.eg.cells(z), integ.mesh.ehat_np.reshape(-1)


def check_close(name, a, b, rtol, atol):
    """|a - b| <= atol + rtol |b| elementwise, NaNs at the same places."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        raise AssertionError(f"{name}: NaN positions differ")
    ok = ~nan_a
    err = (a[ok] - b[ok]).abs()
    bad = err > atol + rtol * b[ok].abs()
    if bool(bad.any()):
        i = int(bad.nonzero()[0])
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol {rtol} atol {atol}; "
            f"first: {float(a[ok][i])} vs {float(b[ok][i])}"
        )
    return float(err.max()) if err.numel() else 0.0


def check_slots(name, a, b, rtol, atol_frac):
    """Channel-major ``[C, N]``: |a - b| <= rtol |b| + atol_frac * (the
    largest finite |b| of the slot), the same non-finite entries."""
    fin_a, fin_b = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fin_a, fin_b) or not torch.equal(a[~fin_b], b[~fin_b]):
        raise AssertionError(f"{name}: non-finite entries differ")
    scale = torch.where(fin_b, b.abs(), 0.0).amax(0, keepdim=True)
    err = torch.where(fin_b, (a - b).abs(), 0.0)
    bad = err > rtol * b.abs() + atol_frac * scale
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} entries out of band")
    return float(err.max())


def compare(label, integ, inputs=None):
    """K1 against its plain version on the first prox inputs of step 0
    (``inputs``, default the stencil engine's). Bands of
    tests/test_prox_pallas2d.py:95-119: ih0 within rtol 2e-5, the
    regularized energies after the solve within rtol 5e-5."""
    from mmadmm_tpu_torch.ops import prox2d as P

    z, dxpu, free, cells = prox_inputs(integ) if inputs is None else inputs
    ehat = integ.mesh.ehat_np.reshape(-1)
    args = (ehat, integ.w, integ.prox_tol, integ.prox_max_iters)
    zk, ihk = P.prox2d(z, dxpu, free, cells, *args)
    torch.cuda.synchronize()
    zp, ihp = P.prox2d_plain(z, dxpu, free, cells, *args)
    rows = [[cells[v * 16 + k] for k in range(16)] for v in range(3)]
    half_w2 = P._consts(integ.w)[1]
    e_k = P.energy_c(list(zk), rows, tuple(ehat), list(dxpu), half_w2)[1]
    e_p = P.energy_c(list(zp), rows, tuple(ehat), list(dxpu), half_w2)[1]
    err_ih = check_close(f"{label} ih0", ihk, ihp, 2e-5, 1e-8)
    err_e = check_close(f"{label} regularized energy", e_k, e_p, 5e-5, 1e-7)
    err_z = float((zk - zp).abs().max())
    same = float((zk == zp).all(0).float().mean())
    say(f"{label}: {z.shape[1]} slots; within bands (ih0 rtol 2e-5, energy rtol 5e-5); "
        f"max |ih0 err| {err_ih:.3e}, max |energy err| {err_e:.3e}, max |z' err| {err_z:.3e}, "
        f"bit-equal z' {100 * same:.2f}% of elements")
    return max(err_ih, err_z), (z, dxpu, free, cells)


def compare3(label, integ):
    """K4 against its plain version on the first prox inputs of step 0:
    bit for bit (the two perform the same float operations in the same
    order; scripts/cuda_host_rehearsal.py agrees bit for bit), and within
    the bands of tests/test_prox_pallas3d.py:88-108 (ih0 rtol 2e-5, the
    regularized energies after the solve rtol 1e-4, atol 1e-6)."""
    from mmadmm_tpu_torch.ops import prox3d as P3
    from mmadmm_tpu_torch.ops.newton import consts

    z, dxpu, free, cells = prox_inputs(integ)
    ehat = integ.mesh.ehat_np.reshape(-1)
    args = (ehat, integ.w, integ.prox_tol, integ.prox_max_iters)
    zk, ihk = P3.prox3d(z, dxpu, free, cells, *args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    zp, ihp = P3.prox3d_plain(z, dxpu, free, cells, *args)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    rows = P3._rows(cells)
    half_w2 = consts(integ.w)[1]
    e_k = P3.energy_c3(list(zk), rows, tuple(ehat), list(dxpu), half_w2)[1]
    e_p = P3.energy_c3(list(zp), rows, tuple(ehat), list(dxpu), half_w2)[1]
    err_ih = check_close(f"{label} ih0", ihk, ihp, 2e-5, 1e-8)
    err_e = check_close(f"{label} regularized energy", e_k, e_p, 1e-4, 1e-6)
    err_z = float((zk - zp).abs().max())
    if not (torch.equal(zk, zp) and torch.equal(ihk, ihp)):
        raise AssertionError(f"{label}: not bit-equal to the plain version "
                             f"(max |z' err| {err_z:.3e}, max |ih0 err| {err_ih:.3e})")
    say(f"{label}: {z.shape[1]} slots; bit-equal (z', ih0) on 100.00% of elements, within bands "
        f"(ih0 rtol 2e-5, energy rtol 1e-4); max |ih0 err| {err_ih:.3e}, max |energy err| "
        f"{err_e:.3e}, max |z' err| {err_z:.3e}; plain version {plain_s:.2f} s")
    return max(err_ih, err_z), (z, dxpu, free, cells)


def compare4c(label, integ):
    """K4' against its plain version on the stock engine's first prox
    inputs of step 0: bit for bit (the two perform the same float
    operations in the same order; the host rehearsal,
    scripts/cuda_host_rehearsal.py, agrees bit for bit), and within the
    bands of tests/test_torch_prox3d_chord.py (ih0 rtol 2e-5, the
    regularized energies after the solve rtol 1e-4, atol 1e-6)."""
    from mmadmm_tpu_torch.ops import prox3d as P3
    from mmadmm_tpu_torch.ops.newton import consts

    inputs = stock_inputs(integ)
    z, dxpu, free, cells, eh = inputs
    args = (integ.w, integ.prox_tol, integ.prox_max_iters)
    zk, ihk = P3.prox3d_chord_comp(*inputs, *args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    zp, ihp = P3.prox3d_chord_comp_plain(*inputs, *args)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    rows = P3._rows(cells)
    half_w2 = consts(integ.w)[1]
    e_k = P3.energy_c3(list(zk), rows, list(eh), list(dxpu), half_w2)[1]
    e_p = P3.energy_c3(list(zp), rows, list(eh), list(dxpu), half_w2)[1]
    err_ih = check_close(f"{label} ih0", ihk, ihp, 2e-5, 1e-8)
    err_e = check_close(f"{label} regularized energy", e_k, e_p, 1e-4, 1e-6)
    err_z = float((zk - zp).abs().max())
    if not (torch.equal(zk, zp) and torch.equal(ihk, ihp)):
        raise AssertionError(f"{label}: not bit-equal to the plain version "
                             f"(max |z' err| {err_z:.3e}, max |ih0 err| {err_ih:.3e})")
    say(f"{label}: {z.shape[1]} tets; bit-equal (z', ih0) on 100.00% of elements, within bands "
        f"(ih0 rtol 2e-5, energy rtol 1e-4); max |ih0 err| {err_ih:.3e}, max |energy err| "
        f"{err_e:.3e}, max |z' err| {err_z:.3e}; plain version {plain_s:.2f} s")
    return max(err_ih, err_z), inputs


def compare4pp(label, integ, variant):
    """K4''a (``variant`` "chord", a box mesh with the constant Ehat) or
    K4''b ("comp", each element's Ehat) against its plain version on the
    stock engine's first prox inputs of step 0: bit for bit (the host
    rehearsal, scripts/cuda_host_rehearsal.py, agrees bit for bit), and
    within the bands of tests/test_torch_prox3d_k4pp.py (ih0 rtol 3e-5, the
    regularized energies rtol 2e-4) if not. Returns ``(max abs error,
    (kernel, plain, inputs, args))``."""
    from mmadmm_tpu_torch.ops import prox3d as P3
    from mmadmm_tpu_torch.ops.newton import consts

    kernel, plain = ((P3.prox3d_chord, P3.prox3d_chord_plain) if variant == "chord"
                     else (P3.prox3d_comp, P3.prox3d_comp_plain))
    inputs, args = stock_call(integ)
    z, dxpu, free, cells = inputs[:4]
    ehat = list(inputs[4]) if variant == "comp" else tuple(integ.mesh.ehat_np.reshape(-1))
    zk, ihk = kernel(*inputs, *args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    zp, ihp = plain(*inputs, *args)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    rows = P3._rows(cells)
    half_w2 = consts(integ.w)[1]
    e_k = P3.energy_c3(list(zk), rows, ehat, list(dxpu), half_w2)[1]
    e_p = P3.energy_c3(list(zp), rows, ehat, list(dxpu), half_w2)[1]
    err_ih = check_close(f"{label} ih0", ihk, ihp, 3e-5, 1e-7)
    err_e = check_close(f"{label} regularized energy", e_k, e_p, 2e-4, 1e-6)
    err_z = float((zk - zp).abs().max())
    if not (torch.equal(zk, zp) and torch.equal(ihk, ihp)):
        raise AssertionError(f"{label}: not bit-equal to the plain version "
                             f"(max |z' err| {err_z:.3e}, max |ih0 err| {err_ih:.3e})")
    say(f"{label}: {z.shape[1]} tets; bit-equal (z', ih0) on 100.00% of elements (max |ih0 "
        f"err| {err_ih:.3e}, max |energy err| {err_e:.3e}, max |z' err| {err_z:.3e}); plain "
        f"version {plain_s:.2f} s")
    return max(err_ih, err_z), (kernel, plain, inputs, args)


def compare_be(label, z, cells, ehat):
    """K2 and K3 against their plain versions, bit for bit (``torch.equal``
    on g, ih and H), after the bands of tests/test_torch_be2d.py: ih within
    rtol 2e-5; g and the 21 Hessian channels within rtol 1e-4 and atol 1e-6
    of the slot's largest entry. Returns ``(K2 max abs error, K3 max abs
    error)``."""
    from mmadmm_tpu_torch.ops import be2d as B

    gk, ihk = B.eg2d(z, cells, ehat)
    Hk = B.hess2d(z, cells, ehat)
    torch.cuda.synchronize()
    gp, ihp = B.eg2d_plain(z, cells, ehat)
    Hp = B.hess2d_plain(z, cells, ehat)
    err_ih = check_slots(f"{label} K2 ih", ihk[None], ihp[None], 2e-5, 0.0)
    err_g = check_slots(f"{label} K2 g", gk, gp, 1e-4, 1e-6)
    err_h = check_slots(f"{label} K3 H", Hk, Hp, 1e-4, 1e-6)
    same_eg = float(((gk == gp).all(0) & (ihk == ihp)).float().mean())
    same_h = float((Hk == Hp).all(0).float().mean())
    say(f"{label}: {z.shape[1]} slots; within bands; K2 max |ih err| {err_ih:.3e}, "
        f"max |g err| {err_g:.3e}, bit-equal {100 * same_eg:.2f}% of slots; "
        f"K3 max |H err| {err_h:.3e}, bit-equal {100 * same_h:.2f}% of slots")
    if not (torch.equal(gk, gp) and torch.equal(ihk, ihp) and torch.equal(Hk, Hp)):
        raise AssertionError(f"{label}: K2 or K3 not bit-equal to its plain version")
    return max(err_ih, err_g), err_h


class _OpCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the elements computed by float arithmetic, comparisons and
    selects (one operation per output element); data movement is not
    counted."""

    OPS = {
        "add", "sub", "rsub", "mul", "div", "neg", "sqrt", "abs", "clamp_min",
        "clamp_max", "where", "gt", "ge", "lt", "le", "eq", "ne", "isfinite",
        "logical_and", "logical_not", "bitwise_and", "bitwise_not", "maximum",
        "reciprocal",
    }

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__.rstrip("_") in self.OPS:
            self.ops += out.numel()
        return out


def time_kernel(fn, n=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_launches(fn, n=20):
    """ms a launch over one run of ``n`` back-to-back calls of ``fn``
    between two CUDA events: where a call's host work is shorter than its
    kernel, the kernels follow each other and the host does not show."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def bare_entry(ops, call):
    """``(out, launch)``: ``call()``'s result, and a function that repeats
    the one C entry of the op module ``ops`` that ``call`` made, with the
    same arguments and into the same outputs, without the wrapper's checks,
    allocations, conversions or count. The entries are those ``ops`` binds
    (its ``_SIGNATURES``), looked up by name on its library."""
    lib, made = ops.library(), []

    def recorder(fn):
        def record(*args):
            made.append((fn, args))
            return fn(*args)
        return record

    saved = {name: getattr(lib, name) for name in ops._SIGNATURES}
    for name, fn in saved.items():
        setattr(lib, name, recorder(fn))
    try:
        out = call()
    finally:
        for name, fn in saved.items():
            setattr(lib, name, fn)
    if len(made) != 1:
        raise AssertionError(f"the wrapper made {len(made)} C calls, not 1")
    fn, args = made[0]

    def launch():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{fn.__name__}: CUDA error {rc}")
    return out, launch


def time_bare(ops, call, runs=5):
    """The median, over ``runs`` runs, of the ms a launch of the C entry
    that ``call`` makes, in runs of 20 back-to-back launches into
    preallocated outputs (``bare_entry``, ``time_launches``)."""
    _, launch = bare_entry(ops, call)
    launch()
    torch.cuda.synchronize()
    return statistics.median(time_launches(launch) for _ in range(runs))


def times(ops, call):
    """``(ms a call of the wrapper, ms a launch of its C entry)``:
    ``time_kernel(call)``, and ``time_bare`` of the C entry of the op module
    ``ops`` that ``call`` makes."""
    return time_kernel(call), time_bare(ops, call)


def time_plain(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t)


def shown(t):
    """``times(...)`` as a row's line prints it."""
    return (f"{t[0]:.4f} ms a call of the wrapper (median of 20 calls), {t[1]:.4f} ms a launch "
            f"of its C entry (median of 5 runs of 20 back-to-back launches)")


def bound(fn, n_floats, f64=False):
    """``(bound ms, bound_by, ops, bytes)`` of a function whose plain
    version ``fn`` does the counted operations and which moves
    ``n_floats`` values (inputs read once, outputs written once): f32
    values at the float32 rate, or with ``f64`` f64 values at the float64
    rate."""
    with _OpCounter() as counter:
        fn()
    nbytes = (8 if f64 else 4) * n_floats
    bytes_ms = 1e3 * nbytes / H100_BYTES_PER_S
    ops_ms = 1e3 * counter.ops / (H100_F64_OPS_PER_S if f64 else H100_F32_OPS_PER_S)
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(bytes_ms, ops_ms), by, counter.ops, nbytes


def work(stats):
    """A plain version's sweep counts: element-sweeps, the Hessians built
    and the retirements on the gradient; for chord sweeps also the
    refreshes (Hessians beyond the one per element at entry)."""
    text = (f"{stats['element_sweeps']} element-sweeps in {stats['sweeps']} sweeps, "
            f"{stats['hessians']} Hessians built")
    if "refreshes" in stats:
        return text + (f" ({stats['refreshes']} of them refreshes), {stats['gnorm_retired']} "
                       f"element-sweeps retired on the gradient before their solve")
    return text + (f" ({stats['gnorm_retired']} element-sweeps retired on the gradient before "
                   f"theirs)")


def k1_work(label, inputs, args, stats):
    """K1's work line at step 0: the plain version's sweep counts
    (``stats``), the sweeps and Hessians of the carved slots (free all 0)
    alone, and the block K1 launches with in the inputs' dtype."""
    from mmadmm_tpu_torch.ops import prox2d as P

    carved = torch.nonzero(inputs[2].sum(0) == 0)[:, 0]
    cs = {}
    P.prox2d_plain(*(t[:, carved].contiguous() for t in inputs), *args, stats=cs)
    e, cols, registers = P.block_shape(inputs[0].dtype)
    say(f"{label}: {work(stats)}; the {carved.numel()} carved slots (free all 0) take "
        f"{cs.get('element_sweeps', 0)} element-sweeps and build {cs.get('hessians', 0)} "
        f"Hessians; K1 launches blocks of {e} elements x 1 thread; {cols} Hessian columns a "
        f"dual pass, into a triangle in {'registers' if registers else 'shared memory'}")


def _wrappers():
    from mmadmm_tpu_torch.ops import be2d as B
    from mmadmm_tpu_torch.ops import prox2d as P
    from mmadmm_tpu_torch.ops import prox3d as P3

    return {"prox2d": P.prox2d, "eg2d": B.eg2d, "hess2d": B.hess2d, "prox3d": P3.prox3d,
            "prox3d_chord_comp": P3.prox3d_chord_comp, "prox3d_chord": P3.prox3d_chord,
            "prox3d_comp": P3.prox3d_comp}


# the wrappers with a float64 build (all of them), whose launches count
# apart as <name>_f64
F64_KERNELS = ("prox2d", "eg2d", "hess2d", "prox3d", "prox3d_chord_comp", "prox3d_chord",
               "prox3d_comp")


def counts():
    c = {name: fn.launches for name, fn in _wrappers().items()}
    c.update({f"{name}_f64": _wrappers()[name].launches_f64 for name in F64_KERNELS})
    return c


def zero_counts():
    for fn in _wrappers().values():
        fn.launches = 0
    for name in F64_KERNELS:
        _wrappers()[name].launches_f64 = 0


def drive(label, cfg, integ, cap=STEP_CAP, times=None):
    """One main path: ``(infos, trace, launch counts)``, the counts set to
    0 just before the run and read just after. Every ``I_h`` must be finite
    and the last below the first. ``times``, if given, gets each step's
    seconds."""
    from mmadmm_tpu_torch.integrators.run_loop import run

    infos = []
    last = [time.perf_counter()]

    def on_step(k, info):
        torch.cuda.synchronize()
        now = time.perf_counter()
        infos.append(info)
        if times is not None:
            times.append(now - last[0])
        extra = "".join(f" {f} {getattr(info, f)}" for f in ("n_iters", "n_newton")
                        if hasattr(info, f))
        say(f"{label} step {k}: ih {info.ih:.9f}{extra} {1e3 * (now - last[0]):.1f} ms")
        last[0] = now

    state = integ.init_state()
    torch.cuda.synchronize()
    zero_counts()
    last[0] = time.perf_counter()
    state, trace, steps = run(integ, state, cap=cap, dt_tol=cfg.dt_tol, on_step=on_step)
    torch.cuda.synchronize()
    launched = counts()
    ih = trace[:steps]
    say(f"{label}: {steps} steps, Ih {ih[0]:.9f} -> {ih[-1]:.9f}; launches {launched}")
    if not all(math.isfinite(v) for v in ih):
        raise AssertionError(f"{label}: non-finite energy in {ih}")
    if not ih[-1] < ih[0]:
        raise AssertionError(f"{label}: energy did not fall: {ih[0]} -> {ih[-1]}")
    if not bool(torch.isfinite(state.x).all()):
        raise AssertionError(f"{label}: non-finite mesh positions")
    return infos, ih, launched


def check_recorded(label, infos, ih):
    """A path of K4 or K4''b against its ``RECORDED_3D`` trace and counts."""
    trace, iters = RECORDED_3D[label]
    got = ([round(float(v), 9) for v in ih], [i.n_iters for i in infos])
    if got != (trace, iters):
        raise AssertionError(f"{label}: I_h trace and ADMM iterations {got} differ from the "
                             f"recorded {(trace, iters)}")
    say(f"{label}: I_h trace and ADMM iterations per step equal the recorded ones "
        f"({len(trace)} steps, {sum(iters)} iterations)")


def expect(label, launched, want):
    """The launch counts of a path: ``want`` for the kernels it names (at
    least one launch), 0 for every other kernel; an empty ``want`` (the
    generic route) means no launch at all."""
    named = bool(want)
    want = {name: want.get(name, 0) for name in launched}
    if launched != want or (named and not any(want.values())):
        raise AssertionError(f"{label}: launches {launched}, expected {want}")


def card_vs_cpu(method):
    """Euler or backward Euler at Shoulder nx=16, SMALL_STEPS steps on the
    card (kernels) and on the CPU (plain versions): Ih within the bands of
    tests/test_torch_euler_be.py (rtol 1e-6 Euler, 1e-5 backward Euler),
    the same Newton counts."""
    runs = []
    for device in ("cuda", "cpu"):
        _, _, integ = shoulder(16, method, device)
        state, infos = integ.init_state(), []
        for _ in range(SMALL_STEPS):
            state, info = integ.step(state)
            infos.append(info)
        runs.append(infos)
    rtol = 1e-6 if method == 1 else 1e-5
    for k, (a, b) in enumerate(zip(*runs)):
        if not math.isclose(a.ih, b.ih, rel_tol=rtol) or a[1:] != b[1:]:
            raise AssertionError(f"method {method} step {k}: card {a} vs cpu {b}")
    say(f"method {method} at Shoulder nx=16: card and CPU agree over {SMALL_STEPS} steps "
        f"(Ih rtol {rtol}): {[round(i.ih, 9) for i in runs[0]]}")


def card_vs_cpu_3d(label, make):
    """3D MM-ADMM at nx=4, SMALL_STEPS steps on the card (the kernel) and
    on the CPU (its plain version): the same ADMM iteration counts and Ih
    within rel 1e-5 (PyTorch's CPU sqrt need not be correctly rounded; the
    card's is, like the kernel's). ``make(device)`` builds the integrator:
    SquareGrid nx=4 on the 3D stencil engine (K4; held to the JAX package
    by tests/test_torch_soa3d_square.py), CompSquare nx=4 on the stock
    engine (K4'; tests/test_torch_admm_stock.py)."""
    runs = []
    for device in ("cuda", "cpu"):
        integ = make(device)
        state, infos = integ.init_state(), []
        for _ in range(SMALL_STEPS):
            state, info = integ.step(state)
            infos.append(info)
        runs.append(infos)
    for k, (a, b) in enumerate(zip(*runs)):
        if not math.isclose(a.ih, b.ih, rel_tol=1e-5) or a.n_iters != b.n_iters:
            raise AssertionError(f"{label} step {k}: card {a} vs cpu {b}")
    say(f"{label}: card and CPU agree over {SMALL_STEPS} steps "
        f"(Ih rtol 1e-5, the same n_iters {[i.n_iters for i in runs[0]]}): "
        f"{[round(i.ih, 9) for i in runs[0]]}")


def card_vs_cpu_generic(label, make):
    """The generic route, SMALL_STEPS steps on the card and on the CPU: the
    same ADMM iteration counts, ``I_h`` within rtol 1e-10. ``make(device)``
    builds the integrator: 2D SquareGrid nx=8 or 3D CompSquare nx=4, both
    in float64 (held to the JAX package by tests/test_torch_admm_generic.py)."""
    runs = []
    for device in ("cuda", "cpu"):
        integ = make(device)
        if integ.mesh.prox_backend != "vmap":
            raise AssertionError(f"{label} took {integ.mesh.prox_backend}")
        state, infos = integ.init_state(), []
        for _ in range(SMALL_STEPS):
            state, info = integ.step(state)
            infos.append(info)
        runs.append(infos)
    for k, (a, b) in enumerate(zip(*runs)):
        if not math.isclose(a.ih, b.ih, rel_tol=1e-10) or a.n_iters != b.n_iters:
            raise AssertionError(f"{label} step {k}: card {a} vs cpu {b}")
    say(f"generic route at {label}: card and CPU agree over {SMALL_STEPS} steps (Ih rtol "
        f"1e-10, the same n_iters {[i.n_iters for i in runs[0]]}): {[i.ih for i in runs[0]]}")


def compare_f64(label, kernel, plain, inputs, args):
    """A float64 kernel against its plain version on the same inputs, bit
    for bit (on the card both round every operation as IEEE float64).
    Returns ``(max abs error, plain version's seconds)``."""
    if inputs[0].dtype != torch.float64:
        raise AssertionError(f"{label}: inputs are {inputs[0].dtype}, not float64")
    out_k = kernel(*inputs, *args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out_p = plain(*inputs, *args)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    out_k = out_k if isinstance(out_k, tuple) else (out_k,)
    out_p = out_p if isinstance(out_p, tuple) else (out_p,)
    err = max(float((a - b).abs().max()) for a, b in zip(out_k, out_p))
    if not all(a.dtype == torch.float64 and torch.equal(a, b) for a, b in zip(out_k, out_p)):
        raise AssertionError(f"{label}: not bit-equal to the plain version (max |err| {err:.3e})")
    say(f"{label}: {inputs[0].shape[1]} slots; float64, bit-equal on 100.00% of elements; "
        f"plain version {plain_s:.2f} s")
    return err, plain_s


def f64_stock(label, n, device="cuda"):
    """The float64 kernel-route configuration of a ``F64_STOCK`` label at
    nx=n: ``(cfg, mesh, integ)``."""
    if "K4''a" in label:
        return square_chord(n, device, "float64")
    return comp_square(n, device, "float64", prox_chord="K4''b" not in label,
                       prox_backend="pallas")


def check_jax_f64(label, infos, ref_label, steps):
    """A float64 kernel-route path against the JAX package's float64 values
    of the same configuration (its generic route, ``JAX_GENERIC``): the
    steps ``steps`` within ``F64_STOCK_RTOL``; the ADMM counts are printed
    beside the JAX package's."""
    for k in steps:
        ref, iters, _ = JAX_GENERIC[ref_label][k]
        ih, rtol = infos[k].ih, F64_STOCK_RTOL[k]
        if not math.isclose(ih, ref, rel_tol=rtol):
            raise AssertionError(f"{label} step {k}: Ih {ih!r} vs the JAX package's {ref!r}, "
                                 f"outside rtol {rtol}")
        say(f"{label} step {k}: Ih {ih!r} within rtol {rtol} of the JAX package's {ref!r} (rel "
            f"{abs(ih / ref - 1):.2e}); {infos[k].n_iters} ADMM iterations, the JAX package "
            f"{iters if iters is not None else 'not recorded'}")


def drive_f64(label, cfg, mesh, integ, engine, f32_ih0):
    """A float64 stencil path. The engine must be ``engine`` with float64
    state; the run (at most
    ``F64_CAP`` steps, the DtTol stop) must launch only float64 kernels, as
    many as the float32 path would (K1 or K4 = ADMM iterations, K2 = steps
    or Newton iterations + 3 per step, K3 = steps). Against the float32
    run of the same configuration, ``f32_ih0 = (initial energy, step-0
    I_h)``: the step-0 ``I_h`` within rtol 1e-6; for backward Euler, whose
    step-0 ``I_h`` is the energy after its first solve, the initial energy
    within rtol 1e-6 and the step-0 ``I_h`` within rtol 1e-5 (its neumann
    band). Returns ``(infos, trace, launches)``."""
    state = integ.init_state()
    if type(integ).__name__ != engine or state.x.dtype != torch.float64:
        raise AssertionError(f"{label}: {type(integ).__name__} with {state.x.dtype} state, "
                             f"expected {engine} in float64")
    infos, ih, launched = drive(label, cfg, integ, F64_CAP)
    method = cfg.method
    if method == 0:
        iters = sum(i.n_iters for i in infos)
        want = {("prox2d_f64" if cfg.dim == 2 else "prox3d_f64"): iters}
    elif method == 1:
        want = {"eg2d_f64": len(infos)}
    else:
        newton = sum(i.n_newton for i in infos)
        want = {"eg2d_f64": newton + BE_EG_PER_STEP * len(infos), "hess2d_f64": len(infos)}
    expect(label, launched, want)
    e0 = float(mesh.energy(mesh.X0))
    for name, got, ref, rtol in (("initial energy", e0, f32_ih0[0], 1e-6),
                                 ("step-0 I_h", float(ih[0]), f32_ih0[1],
                                  1e-5 if method == 2 else 1e-6)):
        if not math.isclose(got, ref, rel_tol=rtol):
            raise AssertionError(f"{label}: {name} {got!r} vs the float32 run's {ref!r}, "
                                 f"outside rtol {rtol}")
    say(f"{label}: launches {want} as counted, float32 kernels 0; initial energy {e0!r}, "
        f"rel {abs(e0 / f32_ih0[0] - 1):.2e} from float32's; step-0 I_h {float(ih[0])!r} "
        f"(float32 {f32_ih0[1]!r}, rel {abs(float(ih[0]) / f32_ih0[1] - 1):.2e})")
    return infos, ih, launched


def card_vs_cpu_f64(label, make):
    """A float64 stencil path, SMALL_STEPS steps on the card (the float64
    kernels) and on the CPU (their plain versions): ``I_h`` within rtol
    1e-10, the same ADMM or Newton counts. ``make(device)`` builds the
    integrator."""
    runs = []
    for device in ("cuda", "cpu"):
        integ = make(device)
        state, infos = integ.init_state(), []
        if state.x.dtype != torch.float64:
            raise AssertionError(f"{label}: {state.x.dtype} state")
        for _ in range(SMALL_STEPS):
            state, info = integ.step(state)
            infos.append(info)
        runs.append(infos)
    for k, (a, b) in enumerate(zip(*runs)):
        if not math.isclose(a.ih, b.ih, rel_tol=1e-10) or any(
                getattr(a, f) != getattr(b, f) for f in ("n_iters", "n_newton")
                if hasattr(a, f)):
            raise AssertionError(f"{label} step {k}: card {a} vs cpu {b}")
    say(f"{label}: card and CPU agree over {SMALL_STEPS} steps in float64 (Ih rtol 1e-10, the "
        f"same inner counts): {[i.ih for i in runs[0]]}")


def check_jax(label, infos):
    """A generic path's ``I_h`` and ADMM counts at the steps the JAX package
    gave (``JAX_GENERIC``)."""
    for k, (ref, iters, rtol) in JAX_GENERIC.get(label, {}).items():
        ih = infos[k].ih
        if not math.isclose(ih, ref, rel_tol=rtol):
            raise AssertionError(f"{label} step {k}: Ih {ih!r} vs the JAX package's {ref!r}, "
                                 f"outside rtol {rtol}")
        if iters is not None and infos[k].n_iters != iters:
            raise AssertionError(f"{label} step {k}: {infos[k].n_iters} ADMM iterations, the "
                                 f"JAX package took {iters}")
        say(f"{label} step {k}: Ih {ih!r} within rtol {rtol} of the JAX package's {ref!r} "
            f"(rel {abs(ih / ref - 1):.2e})"
            + (f", {iters} ADMM iterations as the JAX package" if iters is not None else ""))


def drive_compact(label, make, cap):
    """Explicit or backward Euler on the compact path at full width: the
    integrator ``make()`` builds must evaluate on ``CompactEG``; the run
    (at most ``cap`` steps, the DtTol stop) launches no kernel. Prints its
    ms per step (the mean of steps after the first, and the first), the
    Newton iterations per step and the path's peak device memory: the
    peak of its set-up and run above what the process held before it.
    Returns the infos."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t = time.perf_counter()
    cfg, mesh, integ = make()
    engine = type(integ.eg).__name__
    say(f"{label} set-up: {mesh.n_pnts} nodes, {mesh.n_elements} elements, "
        f"{type(integ).__name__} on {engine}, {mesh.dtype}, Hessian slab {mesh.jac_batch} "
        f"({time.perf_counter() - t:.2f} s)")
    if engine != "CompactEG":
        raise AssertionError(f"{label}: {engine}, not the compact path")
    times = []
    infos, ih, launched = drive(label, cfg, integ, cap, times)
    expect(label, launched, {})
    later = times[1:] or times
    newton = [i.n_newton for i in infos] if cfg.method == 2 else "none (explicit)"
    say(f"{label}: {len(infos)} steps, {1e3 * sum(later) / len(later):.1f} ms per step after the "
        f"first ({1e3 * times[0]:.1f} ms the first), Newton iterations per step {newton}, peak "
        f"device memory {(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB above the "
        f"{held / 2**30:.2f} GiB held before it, every kernel launch count 0; Ih trace "
        f"{[float(v) for v in ih]}")
    return infos


def check_jax_compact(label, method, infos):
    """Monitor3320r's compact Euler or backward Euler against the JAX
    package's values (``JAX_COMPACT_M3320R``)."""
    for k, (ref, newton) in JAX_COMPACT_M3320R[method].items():
        ih = infos[k].ih
        if not math.isclose(ih, ref, rel_tol=COMPACT_RTOL):
            raise AssertionError(f"{label} step {k}: Ih {ih!r} vs the JAX package's {ref!r}, "
                                 f"outside rtol {COMPACT_RTOL}")
        if newton is not None and infos[k].n_newton != newton:
            raise AssertionError(f"{label} step {k}: {infos[k].n_newton} Newton iterations, "
                                 f"the JAX package took {newton}")
        say(f"{label} step {k}: Ih {ih!r} within rtol {COMPACT_RTOL} of the JAX package's "
            f"{ref!r} (rel {abs(ih / ref - 1):.2e})"
            + (f", {newton} Newton iterations as the JAX package" if newton is not None else ""))


def recorded(call):
    """``(call(), mesh, integrator, infos)``: ``call()`` builds its
    problem through the harness runner; the ``(mesh, integrator)`` it built
    (the last, if several) and the info of every step that integrator took
    (the runner's thrown-away first step first) are recorded on the way."""
    from mmadmm_tpu_torch.harness import runner

    made, infos = [], []
    build = runner.build_problem

    def recording_build(cfg, device=None, **kw):
        mesh, integ = build(cfg, device, **kw)
        step = integ.step

        def recording_step(state):
            state, info = step(state)
            infos.append(info)
            return state, info

        integ.step = recording_step
        made.append((mesh, integ))
        return mesh, integ

    runner.build_problem = recording_build
    try:
        out = call()
    finally:
        runner.build_problem = build
    mesh, integ = made[-1]
    del integ.step  # the class's step again
    return out, mesh, integ, infos


def check_artifacts(label, out_dir, method, steps):
    """The runner's artifacts in ``out_dir``: the five files, ``Ih<m>.txt``
    with ``steps`` + 1 rows (the initial energy first) and
    ``summary.json`` with the JAX runner's keys."""
    import os

    names = ["points.txt", "triangles.txt", "mask.txt", f"Ih{method}.txt", "summary.json"]
    missing = [n for n in names if not os.path.isfile(os.path.join(out_dir, n))]
    if missing:
        raise AssertionError(f"{label}: artifacts {missing} not written")
    with open(os.path.join(out_dir, f"Ih{method}.txt")) as f:
        rows = f.read().splitlines()
    if len(rows) != steps + 1:
        raise AssertionError(f"{label}: Ih{method}.txt has {len(rows)} rows, not {steps + 1}")
    with open(os.path.join(out_dir, "summary.json")) as f:
        keys = set(json.load(f))
    if keys != SUMMARY_KEYS:
        raise AssertionError(f"{label}: summary.json keys {sorted(keys)}")
    sizes = ", ".join(f"{n} {os.path.getsize(os.path.join(out_dir, n))} B" for n in names)
    say(f"{label}: artifacts written ({sizes}); Ih{method}.txt {len(rows)} rows = steps + 1")


def drive_tier(label, cfg_path, method, steps, tmp):
    """One run at the 6.1M-tet tier through the harness runner
    (``run_experiment``, the CLI's code) on the config file at
    ``cfg_path``, capped at ``steps`` steps: its set-up, first-step and
    per-step times, the peak device memory of set-up and run above what
    the process held before (``max_memory_allocated`` after
    ``reset_peak_memory_stats``), the launches, ``I_h`` finite and
    falling, and the artifacts. MM-ADMM launches K4 in float64 once an
    ADMM iteration (the thrown-away first step's included), every other
    count 0; explicit and backward Euler (the compact path) launch
    nothing. Returns ``(result, mesh, integrator, loop infos, launches)``."""
    import os

    from mmadmm_tpu_torch import load_experiment_config
    from mmadmm_tpu_torch.harness.runner import run_experiment

    cfg = load_experiment_config(cfg_path, method=method)
    cfg.n_steps = steps
    out = os.path.join(tmp, f"{cfg.name}_m{method}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_counts()
    res, mesh, integ, infos = recorded(lambda: run_experiment(cfg, out_dir=out))
    torch.cuda.synchronize()
    launched = counts()
    peak = torch.cuda.max_memory_allocated() - held
    ih = res.ih_trace
    inner = ([i.n_iters for i in infos] if method == 0 else
             [i.n_newton for i in infos] if method == 2 else "none (explicit)")
    say(f"{label}: {type(integ).__name__}, {mesh.dtype}, {mesh.n_pnts} nodes, {mesh.n_elements} "
        f"elements{f', {integ.NFd} slots' if hasattr(integ, 'NFd') else ''}; set-up "
        f"{res.setup_time:.2f} s, first step (thrown away) {res.compile_time:.2f} s, "
        f"{res.n_steps} steps in {res.loop_time:.2f} s = {1e3 * res.loop_time / res.n_steps:.1f} ms "
        f"per step; {'ADMM' if method == 0 else 'Newton'} iterations per step {inner} (the "
        f"first step's first); peak device memory {peak / 2**30:.2f} GiB above the "
        f"{held / 2**30:.2f} GiB held before it; Ih trace {ih}")
    if res.n_steps != steps or len(infos) != steps + 1:
        raise AssertionError(f"{label}: {res.n_steps} steps ({len(infos)} step calls), "
                             f"expected {steps}")
    if res.failed or not all(math.isfinite(v) for v in ih) or not ih[-1] < ih[0]:
        raise AssertionError(f"{label}: I_h not finite and falling: {ih}")
    if method == 0:
        want = {"prox3d_f64": sum(i.n_iters for i in infos)}
        expect(label, launched, want)
        say(f"{label}: K4 float64 launches {launched['prox3d_f64']} = ADMM iterations "
            f"{want['prox3d_f64']} ({sum(i.n_iters for i in infos[1:])} in the loop), every "
            f"other count 0")
    else:
        expect(label, launched, {})
        say(f"{label}: every kernel launch count 0 (the compact path)")
    check_artifacts(label, out, method, steps)
    shutil.rmtree(out)
    return res, mesh, integ, infos[1:], launched


def compare_tier_k4(label, integ):
    """K4 float64 at the tier: one launch over every slot of the step-0
    prox inputs, held bit for bit to its plain version run on slabs of
    ``TIER_SLAB`` slots (an element's result depends on no other); its
    wrapper call and bare device time, and its bound on these inputs."""
    from mmadmm_tpu_torch.ops import prox3d as P3

    (z, dxpu, free, cells), args = prox_call(integ)
    n = z.shape[1]
    zk, ihk = P3.prox3d(z, dxpu, free, cells, *args)
    torch.cuda.synchronize()
    slabs = [slice(a, min(a + TIER_SLAB, n)) for a in range(0, n, TIER_SLAB)]

    def plain(stats=None):
        return [P3.prox3d_plain(*(t[:, s].contiguous() for t in (z, dxpu, free, cells)), *args,
                                stats=stats) for s in slabs]

    t = time.perf_counter()
    out = plain()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    for s, (zp, ihp) in zip(slabs, out):
        if not (torch.equal(zk[:, s], zp) and torch.equal(ihk[s], ihp)):
            err = float((zk[:, s] - zp).abs().max())
            raise AssertionError(f"{label}: K4 float64 not bit-equal to its plain version on "
                                 f"slots {s.start}-{s.stop} (max |z' err| {err:.3e})")
    del out
    stats = {}
    per_elem4 = 12 + 12 + 12 + 216 + 12 + 1
    b = bound(lambda: plain(stats), n * per_elem4, f64=True)

    def call():
        return P3.prox3d(z, dxpu, free, cells, *args)

    ms = (time_kernel(call, n=5), time_bare(P3, call, runs=1))
    say(f"K4 float64 vs plain, {label} step 0: {n} slots, bit-equal (z', ih0) on 100.00% of "
        f"elements, the plain version on {len(slabs)} slabs of at most {TIER_SLAB} slots in "
        f"{plain_s:.2f} s; {ms[0]:.4f} ms a call of the wrapper (median of 5 calls), "
        f"{ms[1]:.4f} ms a launch of its C entry (20 back-to-back launches); bound "
        f"{b[0]:.4f} ms by {b[1]} ({b[2]:.4e} operations at 33.5 TFLOP/s, {b[3]} bytes at "
        f"3.35 TB/s), the C entry at {100 * b[0] / ms[1]:.1f} % of it; {work(stats)}")


def cli_monitor3320r(tmp, dtype=None):
    """``Experiments/InputFiles/Monitor3320r.json`` through the CLI
    (``mmadmm_tpu_torch.run.main``), ``TIER_CLI_STEPS`` steps on the card:
    as loaded (float64, the generic route: no launch; steps 0 and 1
    against the JAX package's ``JAX_GENERIC`` values and ADMM counts) or
    with ``--dtype float32`` (the stock engine with K1: launches = ADMM
    iterations; step 0 within rtol 1e-6 of the JAX package's). Returns the
    launch counts."""
    import os

    from mmadmm_tpu_torch import run as cli

    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "Experiments", "InputFiles", "Monitor3320r.json")
    out = os.path.join(tmp, f"Monitor3320r_{dtype or 'as_loaded'}")
    argv = [path, "0", "--steps", str(TIER_CLI_STEPS), "--out", out, "--device", "cuda"]
    argv += ["--dtype", dtype] if dtype else []
    label = f"CLI Monitor3320r {dtype or 'as loaded (float64)'}"
    zero_counts()
    t = time.perf_counter()
    rc, mesh, integ, infos = recorded(lambda: cli.main(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launched = counts()
    if rc != 0:
        raise AssertionError(f"{label}: the CLI returned {rc}")
    loop = infos[1:]
    say(f"{label}: `python -m mmadmm_tpu_torch.run {' '.join(argv[1:])}` in {wall:.2f} s; "
        f"{type(integ).__name__}, prox {mesh.prox_backend}, {mesh.dtype}; Ih "
        f"{[i.ih for i in loop]}, ADMM iterations {[i.n_iters for i in loop]}; launches "
        f"{launched}")
    if len(loop) != TIER_CLI_STEPS:
        raise AssertionError(f"{label}: {len(loop)} steps, not {TIER_CLI_STEPS}")
    if dtype is None:
        expect(label, launched, {})
        check_jax("Monitor3320r float64", loop)
    else:
        want = {"prox2d": sum(i.n_iters for i in infos)}
        expect(label, launched, want)
        ref, ih0 = JAX_STEP0_IH["Monitor3320r"], loop[0].ih
        if not math.isclose(ih0, ref, rel_tol=1e-6):
            raise AssertionError(f"{label}: step-0 Ih {ih0!r} vs the JAX package's {ref!r}, "
                                 f"outside rtol 1e-6")
        say(f"{label}: K1 launches {want['prox2d']} = ADMM iterations (the thrown-away first "
            f"step's included); step-0 Ih {ih0!r} within rtol 1e-6 of the JAX package's "
            f"{ref!r} (rel {abs(ih0 / ref - 1):.2e})")
    check_artifacts(label, out, 0, TIER_CLI_STEPS)
    shutil.rmtree(out)
    return launched


def resume_on_card(tmp):
    """Shoulder-320 in float32 (MM-ADMM, K1), 4 steps through the runner
    with a checkpoint every 2, against 2 steps, the step-2 checkpoint, a
    resume and 2 more: the step-4 checkpoints of the two runs hold the same
    state bit for bit (``x`` first), and the resumed run's energies equal
    the uninterrupted run's."""
    import os

    import numpy as np

    from mmadmm_tpu_torch import ExperimentConfig
    from mmadmm_tpu_torch.harness.runner import run_experiment

    cfg = ExperimentConfig(
        name="Shoulder-320", test_type="Shoulder", dim=2, mon_type=1, nx=320, ny=320,
        dt=5e-3, tau=0.1, rho=50.0, dtype="float32", n_steps=4, dt_tol=1e-12,
    )
    a, b = os.path.join(tmp, "resume_full"), os.path.join(tmp, "resume_b")
    t = time.perf_counter()
    full = run_experiment(cfg, out_dir=a, checkpoint_every=2)
    part = run_experiment(cfg, out_dir=b, checkpoint_every=2,
                          resume_from=os.path.join(a, "checkpoints", "step_000002.npz"))
    wall = time.perf_counter() - t
    with np.load(os.path.join(a, "checkpoints", "step_000004.npz")) as za, \
            np.load(os.path.join(b, "checkpoints", "step_000004.npz")) as zb:
        if sorted(za.files) != sorted(zb.files):
            raise AssertionError(f"resume: checkpoint keys {za.files} vs {zb.files}")
        differ = [k for k in za.files if not np.array_equal(za[k], zb[k])]
        keys = za.files
    if differ or part.n_steps != 4 or part.ih_trace[1:] != full.ih_trace[3:]:
        raise AssertionError(f"resume: fields {differ} differ, or the energies "
                             f"{part.ih_trace[1:]} vs {full.ih_trace[3:]}")
    say(f"resume on the card, Shoulder-320 float32: 4 steps against 2 + checkpoint + resume + 2 "
        f"({wall:.2f} s for both runs): the step-4 state bit-equal in every field "
        f"({', '.join(k for k in keys if k != 'config')}); steps 2-3 Ih {part.ih_trace[1:]} as "
        f"the uninterrupted run's")
    shutil.rmtree(a)
    shutil.rmtree(b)


def harness_phases():
    """The experiment harness on the card (after every other phase, with
    their memory handed back): 3D SquareGrid-80 and Shoulder-80 MM-ADMM in
    float64 through the runner (the 6.1M-tet tier, K4 float64 held bit for
    bit at step 0 and timed), methods 1 and 2 at SquareGrid-80, Monitor3320r
    through the CLI in both dtypes, and a checkpointed and resumed run.
    The configs are written with ``make_config_json``, as a user writes
    them. Returns the launch counts by path."""
    import os
    import tempfile

    from mmadmm_tpu_torch.harness.experiments import make_config_json

    launched = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for label, test_type, mon in (("3D SquareGrid-80", "SquareGrid", 1),
                                      ("3D Shoulder-80", "Shoulder", 0)):
            path = make_config_json(os.path.join(tmp, f"{label.split()[1].replace('-', '')}.json"),
                                    dim=3, test_type=test_type, mon_type=mon, nx=TIER_N,
                                    dt=5e-3, tau=0.1, rho=50.0, dt_tol=TIER_DT_TOL)
            _, mesh, integ, _, launched[label] = drive_tier(f"tier {label} MM-ADMM", path, 0,
                                                            TIER_STEPS, tmp)
            if type(integ).__name__ != "SoAADMM3D" or mesh.dtype != torch.float64:
                raise AssertionError(f"{label}: {type(integ).__name__} in {mesh.dtype}, not the "
                                     f"3D stencil engine in float64")
            compare_tier_k4(label, integ)
            del mesh, integ
            if label.endswith("SquareGrid-80"):
                square = path
        for method in (1, 2):
            _, _, _, _, launched[f"SquareGrid-80 m{method}"] = drive_tier(
                f"tier 3D SquareGrid-80 {'explicit' if method == 1 else 'backward'} Euler", square,
                method, TIER_EULER_STEPS, tmp)
        for dtype in (None, "float32"):
            launched[f"CLI Monitor3320r {dtype or 'float64'}"] = cli_monitor3320r(tmp, dtype)
        resume_on_card(tmp)
    return launched


# ---- runs over ranks (ROADMAP A15): 2 ranks on the one card over gloo --------
SHARD_RANKS = 2
SHARD_BACKEND = "gloo"  # NCCL refuses two ranks on one device
SHARD_TIMEOUT_S = 600  # a rank that fails or hangs ends the run
SHARD_K1 = "Monitor3320r float32 K1"
SHARD_K4C = "3D CompSquare-40 float64 K4'"
SHARD_EULER = "explicit Euler Monitor3320r float64"
SHARD_BE = "backward Euler (hess) Monitor3320r float64"
# steps and the I_h band against the one-card run of the same configuration
SHARD_STEPS = {SHARD_K1: 10, SHARD_K4C: 4, SHARD_EULER: 2, SHARD_BE: 2}
SHARD_RTOL = {SHARD_K1: 1e-5, SHARD_K4C: 1e-9, SHARD_EULER: 1e-9, SHARD_BE: 1e-9}


def shard_steps(integ, steps, group=None):
    """``steps`` steps from the initial state, every launch count set to 0
    just before and read just after: ``{ih, counts, launches, ms}``. The
    ranks of ``group`` start the clock together (an all-reduce first), so
    no rank's time holds its wait for another's set-up."""
    state = integ.init_state()
    if group is not None:
        group.all_reduce_sum(torch.zeros(1, device=group.device))
    torch.cuda.synchronize()
    zero_counts()
    t = time.perf_counter()
    ih, inner = [], []
    for _ in range(steps):
        state, info = integ.step(state)
        ih.append(info.ih)
        inner.append(getattr(info, "n_iters", getattr(info, "n_newton", 0)))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t) / steps
    if not all(math.isfinite(v) for v in ih) or not bool(torch.isfinite(state.x).all()):
        raise AssertionError(f"non-finite energy or positions: {ih}")
    return dict(ih=ih, counts=inner, launches=counts(), ms=ms)


def shard_admm(label, integ, name, kernel, plain, args, group=None):
    """A kernel-route MM-ADMM path on this rank's shard (or one card): the
    kernel against its plain version on the rank's step-0 prox inputs,
    then ``SHARD_STEPS`` steps; the kernel's launches must equal the ADMM
    iterations, every other count 0."""
    inputs = stock_inputs(integ)
    zk, ihk = kernel(*inputs, *args)
    zp, ihp = plain(*inputs, *args)
    out = shard_steps(integ, SHARD_STEPS[label], group)
    expect(label, out["launches"], {name: sum(out["counts"])})
    out.update(equal=torch.equal(zk, zp) and torch.equal(ihk, ihp), elements=inputs[0].shape[1],
               err=max(float((zk - zp).abs().max()), float((ihk - ihp).abs().max())))
    return out


def shard_paths(group=None):
    """The sharded phase's paths on this rank of ``group``, or on the one
    card with ``group=None``: Monitor3320r in float32 on the kernel route
    (K1), 3D CompSquare-40 in float64 on the kernel route (K4' float64),
    explicit and backward Euler (``hess``) at Monitor3320r in float64."""
    from mmadmm_tpu_torch.integrators.backward_euler import BackwardEulerIntegrator
    from mmadmm_tpu_torch.ops import prox2d as P
    from mmadmm_tpu_torch.ops import prox3d as P3

    out = {}
    _, mesh, integ = monitor3320r(group=group)
    out[SHARD_K1] = shard_admm(SHARD_K1, integ, "prox2d", P.prox2d, P.prox2d_plain,
                               (mesh.ehat_np.reshape(-1), integ.w, integ.prox_tol,
                                integ.prox_max_iters), group)
    _, mesh, integ = comp_square(40, dtype="float64", prox_chord=True, prox_backend="pallas",
                                 group=group)
    out[SHARD_K4C] = shard_admm(SHARD_K4C, integ, "prox3d_chord_comp_f64", P3.prox3d_chord_comp,
                                P3.prox3d_chord_comp_plain,
                                (integ.w, integ.prox_tol, integ.prox_max_iters), group)
    del mesh, integ
    for label, method in ((SHARD_EULER, 1), (SHARD_BE, 2)):
        cfg, mesh, integ = monitor3320r(as_loaded=True, method=method, group=group)
        if method == 2:
            integ = BackwardEulerIntegrator(mesh, cfg.dt, tol=cfg.step_tol, krylov_solver="hess",
                                            group=group)
        out[label] = shard_steps(integ, SHARD_STEPS[label], group)
        expect(label, out[label]["launches"], {})
        del mesh, integ
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _shard_rank(group):
    """One rank of the sharded phase: the dry run's traces and the paths."""
    from mmadmm_tpu_torch.dryrun import rank_traces

    return {"backend": group.backend, "device": str(group.device),
            "dryrun": rank_traces(group), "paths": shard_paths(group)}


def sharded_phase():
    """Runs over ranks (ROADMAP A15), ``SHARD_RANKS`` ranks on the one card
    over gloo: the dry run's problem (2D SquareGrid nx=22, float64) on
    ``n_ranks`` and 3 ranks against one card (``I_h`` within 1e-9, equal
    ADMM counts, one step of each Euler method), and ``shard_paths`` on
    ``n_ranks`` against one card: K1 and K4' float64 launched on every
    rank and bit-equal to their plain versions on the rank's step-0 shard
    inputs, ``I_h`` within ``SHARD_RTOL`` of the one-card run, the float64
    counts equal (the float32 ones printed beside each other). Ranks that
    share a card give no scaling number. Returns the ranks' launches of K1
    and K4' float64."""
    from mmadmm_tpu_torch import dryrun as DR
    from mmadmm_tpu_torch.parallel import launch

    n_ranks, backend = SHARD_RANKS, SHARD_BACKEND
    t = time.perf_counter()
    one = shard_paths()
    one_dry = {m: DR.trace(None, m, DR.N_STEPS if m == 0 else 1, "cuda") for m in (0, 1, 2)}
    say(f"sharded phase: one-card runs in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ranks = launch(_shard_rank, n_ranks, backend=backend, device="cuda",
                   timeout_s=SHARD_TIMEOUT_S)
    say(f"sharded phase: {n_ranks} ranks over {ranks[0]['backend']} on "
        f"{[r['device'] for r in ranks]} in {time.perf_counter() - t:.1f} s (spawn included)")
    t = time.perf_counter()
    three = launch(DR.rank_traces, 3, backend=backend, device="cuda", timeout_s=SHARD_TIMEOUT_S)
    say(f"sharded phase: 3 ranks over {backend} in {time.perf_counter() - t:.1f} s")
    for k, runs in ((n_ranks, [r["dryrun"] for r in ranks]), (3, three)):
        for m in (0, 1, 2):
            ihs1, counts1 = one_dry[m]
            for r, run in enumerate(runs):
                ihs, cnt = run[m]
                if not (DR._close(ihs1, ihs) and cnt == counts1):
                    raise AssertionError(f"dry run method {m}, rank {r} of {k}: {ihs} {cnt} "
                                         f"against one card {ihs1} {counts1}")
        say(f"dry run on {k} ranks: MM-ADMM I_h {runs[0][0][0]} ADMM {runs[0][0][1]}, Euler "
            f"{runs[0][1][0]}, backward Euler {runs[0][2][0]} Newton {runs[0][2][1]}: within "
            f"{DR.RTOL} of one card, equal counts")
    launched = {}
    for label in SHARD_STEPS:
        ref = one[label]
        for r, rank in enumerate(ranks):
            got = rank["paths"][label]
            if got["ih"] != ranks[0]["paths"][label]["ih"]:
                raise AssertionError(f"{label}: rank {r} read other I_h bits than rank 0")
            if "equal" in got and not got["equal"]:
                raise AssertionError(f"{label}, rank {r}: the kernel differs from its plain "
                                     f"version on the rank's step-0 inputs (max err {got['err']})")
            worst = max(abs(a - b) / abs(b) for a, b in zip(got["ih"], ref["ih"]))
            if worst > SHARD_RTOL[label]:
                raise AssertionError(f"{label}, rank {r}: I_h {got['ih']} against one card "
                                     f"{ref['ih']} (rel {worst:.3e} > {SHARD_RTOL[label]})")
            if SHARD_RTOL[label] < 1e-6 and got["counts"] != ref["counts"]:
                raise AssertionError(f"{label}, rank {r}: counts {got['counts']} against one "
                                     f"card {ref['counts']}")
        kernel = {k: v for k, v in ranks[0]["paths"][label]["launches"].items() if v}
        for name in kernel:
            launched[name] = launched.get(name, 0) + sum(rank["paths"][label]["launches"][name]
                                                         for rank in ranks)
        got = ranks[0]["paths"][label]
        shard = (f"; kernel bit-equal to its plain version on each rank's step-0 shard "
                 f"({[rank['paths'][label]['elements'] for rank in ranks]} elements; one card "
                 f"{ref['elements']})" if "equal" in got else "")
        say(f"{label}: {n_ranks} ranks, launches a rank {kernel or 'none'}; I_h "
            f"{got['ih']} (one card {ref['ih']}), counts {got['counts']} (one card "
            f"{ref['counts']}); ms a step {[round(rank['paths'][label]['ms'], 1) for rank in ranks]}"
            f" on the ranks ({[rank['device'] for rank in ranks]}), {ref['ms']:.1f} on one "
            f"card{shard}")
    return launched


def kernel_and_path_phases() -> list:
    """Every kernel against its plain version, the main paths and the
    kernels' timing (steps 3-5 of the module docstring). Returns the rows
    of the kernels line; everything else it made is handed back on
    return."""
    from mmadmm_tpu_torch.ops import be2d as B
    from mmadmm_tpu_torch.ops import prox2d as P
    from mmadmm_tpu_torch.ops import prox3d as P3

    # ---- kernels vs plain ------------------------------------------------------
    _, _, small = shoulder(16)
    compare("K1 vs plain, Shoulder nx=16", small)
    _, _, small_eg = shoulder(16, 1)
    compare_be("K2/K3 vs plain, Shoulder nx=16", *be_inputs(small_eg))
    t = time.perf_counter()
    cfg, mesh, integ = shoulder(320)
    say(f"Shoulder-320 set-up: {mesh.n_pnts} nodes, {mesh.n_elements} live "
        f"triangles, {integ.NFd} slots ({time.perf_counter() - t:.2f} s)")
    k1_err, inputs = compare("K1 vs plain, Shoulder-320 step 0", integ)
    cfg_e, _, euler = shoulder(320, 1)
    cfg_b, _, be = shoulder(320, 2)
    be_in = be_inputs(euler)
    k2_err, k3_err = compare_be("K2/K3 vs plain, Shoulder-320 step 0", *be_in)
    _, _, small3 = box3d("SquareGrid", 1, 4)
    compare3("K4 vs plain, 3D SquareGrid nx=4", small3)
    box = {}
    for label, tt, mon in (("3D Shoulder-40", "Shoulder", 0), ("3D SquareGrid-40", "SquareGrid", 1)):
        t = time.perf_counter()
        cfg3, mesh3, integ3 = box3d(tt, mon, 40)
        grid = "constant grid" if mesh3.grid.constant else "48-wide cell table"
        say(f"{label} set-up: {mesh3.n_pnts} nodes, {mesh3.n_elements} live tets, "
            f"{integ3.NFd} slots, {grid} ({time.perf_counter() - t:.2f} s)")
        err, inputs3 = compare3(f"K4 vs plain, {label} step 0", integ3)
        box[label] = (cfg3, integ3, err, inputs3)
    _, _, small_c = comp_square(4)
    compare4c("K4' vs plain, 3D CompSquare nx=4 (stock engine)", small_c)
    stock = {}
    for label, make in (("3D CompSquare-20", lambda: comp_square(20)),
                        ("3D CompSquare-40", lambda: comp_square(40)),
                        ("Monitor3320r", monitor3320r)):
        t = time.perf_counter()
        cfg_s, mesh_s, integ_s = make()
        say(f"{label} set-up: {mesh_s.n_pnts} nodes, {mesh_s.n_elements} elements, "
            f"{type(integ_s).__name__} ({time.perf_counter() - t:.2f} s)")
        stock[label] = [cfg_s, integ_s, None, None]
    for label in ("3D CompSquare-20", "3D CompSquare-40"):
        stock[label][2:] = compare4c(f"K4' vs plain, {label} step 0", stock[label][1])
    compare4pp("K4''a vs plain, 3D SquareGrid nx=4 (stock engine, prox_chord=True)",
               square_chord(4)[2], "chord")
    compare4pp("K4''b vs plain, 3D CompSquare nx=4 (stock engine, prox_chord=False)",
               comp_square(4, prox_chord=False)[2], "comp")
    compare4pp("K4''a vs plain, 3D SquareGrid-20 step 0", square_chord(20)[2], "chord")
    compare4pp("K4''b vs plain, 3D CompSquare-20 step 0", comp_square(20, prox_chord=False)[2],
               "comp")
    m_integ = stock["Monitor3320r"][1]
    m_in = stock_inputs(m_integ)
    stock["Monitor3320r"][2:] = compare("K1 vs plain, Monitor3320r step 0 (element-major entry)",
                                        m_integ, m_in)
    _, x, z, u = m_integ.start(m_integ.init_state())
    ze, ihe = P.prox_elements(m_integ.mesh.grid, z, m_integ.gather(x) + u, m_integ.free,
                              m_integ.mesh.ehat_np.reshape(-1), m_integ.w, m_integ.prox_tol,
                              m_integ.prox_max_iters)
    zc, ihc = P.prox2d(*m_in, m_integ.mesh.ehat_np.reshape(-1), m_integ.w, m_integ.prox_tol,
                       m_integ.prox_max_iters)
    if not (torch.equal(ze, zc.T.reshape(-1, 3, 2)) and torch.equal(ihe, ihc)):
        raise AssertionError("K1's element-major entry differs from its channel call")
    say("K1's element-major entry equals its channel call on Monitor3320r's step-0 inputs")
    # the float64 builds of K1-K3 and K4, bit for bit, on the float64
    # stencil engines' step-0 inputs, at nx=16 / nx=4 and on the main paths'
    compare_f64("K1 float64 vs plain, Shoulder nx=16", P.prox2d, P.prox2d_plain,
                *prox_call(shoulder(16, dtype="float64")[2]))
    zs64, cs64, ehs64 = be_inputs(shoulder(16, 1, dtype="float64")[2])
    compare_f64("K2 float64 vs plain, Shoulder nx=16", B.eg2d, B.eg2d_plain, (zs64, cs64),
                (ehs64,))
    compare_f64("K3 float64 vs plain, Shoulder nx=16", B.hess2d, B.hess2d_plain, (zs64, cs64),
                (ehs64,))
    compare_f64("K4 float64 vs plain, 3D SquareGrid nx=4", P3.prox3d, P3.prox3d_plain,
                *prox_call(box3d("SquareGrid", 1, 4, dtype="float64")[2]))
    # the float64 builds of K4', K4''a and K4''b on the float64 kernel
    # route's step-0 inputs at nx=4 (and, below, on their paths' at -20/-40)
    for label, name, *_ in F64_STOCK[1:]:
        compare_f64(f"{name} float64 vs plain, {label.replace('-40', '')} nx=4",
                    _wrappers()[name], getattr(P3, f"{name}_plain"),
                    *stock_call(f64_stock(label, 4)[2]))
    f64 = {}
    for label, make in (("MM-ADMM float64", lambda: shoulder(320, 0, dtype="float64")),
                        ("Euler float64", lambda: shoulder(320, 1, dtype="float64")),
                        ("backward Euler float64", lambda: shoulder(320, 2, dtype="float64")),
                        ("3D Shoulder-40 float64", lambda: box3d("Shoulder", 0, 40,
                                                                 dtype="float64")),
                        ("3D SquareGrid-40 float64", lambda: box3d("SquareGrid", 1, 40,
                                                                   dtype="float64"))):
        t = time.perf_counter()
        f64[label] = make()
        mesh64 = f64[label][1]
        say(f"{label} set-up: {type(f64[label][2]).__name__}, {mesh64.dtype}, "
            f"{mesh64.n_elements} live elements ({time.perf_counter() - t:.2f} s)")
    k1_64 = prox_call(f64["MM-ADMM float64"][2])
    k1_64_err = compare_f64("K1 float64 vs plain, Shoulder-320 float64 step 0", P.prox2d,
                            P.prox2d_plain, *k1_64)[0]
    zb64, cb64, eh64 = be_inputs(f64["Euler float64"][2])
    k2_64_err = compare_f64("K2 float64 vs plain, Shoulder-320 float64 step 0", B.eg2d,
                            B.eg2d_plain, (zb64, cb64), (eh64,))[0]
    k3_64_err = compare_f64("K3 float64 vs plain, Shoulder-320 float64 step 0", B.hess2d,
                            B.hess2d_plain, (zb64, cb64), (eh64,))[0]
    k4_64 = {}
    for label in ("3D Shoulder-40 float64", "3D SquareGrid-40 float64"):
        call = prox_call(f64[label][2])
        err, plain_s = compare_f64(f"K4 float64 vs plain, {label} step 0", P3.prox3d,
                                   P3.prox3d_plain, *call)
        k4_64[label] = (call, err, plain_s)

    # ---- main paths -----------------------------------------------------------
    infos, ih, launched = drive("MM-ADMM", cfg, integ)
    f32_ih0 = {"MM-ADMM float64": (float(integ.mesh.energy(integ.mesh.X0)), float(ih[0]))}
    iters = sum(i.n_iters for i in infos)
    expect("MM-ADMM", launched, {"prox2d": iters, "eg2d": 0, "hess2d": 0, "prox3d": 0})
    say(f"MM-ADMM: K1 launches {launched['prox2d']} = ADMM iterations {iters}; "
        f"step-0 Ih {ih[0]:.6f} beside the reference's recorded Monitor1320 initial Ih "
        f"{MONITOR1320_IH0} (information: dt/rho may differ from its JSON)")
    infos_e, ih_e, launched_e = drive("Euler", cfg_e, euler)
    f32_ih0["Euler float64"] = (float(euler.mesh.energy(euler.mesh.X0)), float(ih_e[0]))
    expect("Euler", launched_e, {"prox2d": 0, "eg2d": len(infos_e), "hess2d": 0, "prox3d": 0})
    say(f"Euler: K2 launches {launched_e['eg2d']} = steps {len(infos_e)}")
    infos_b, ih_b, launched_b = drive("backward Euler", cfg_b, be)
    f32_ih0["backward Euler float64"] = (float(be.mesh.energy(be.mesh.X0)), float(ih_b[0]))
    newton = sum(i.n_newton for i in infos_b)
    expect("backward Euler", launched_b, {
        "prox2d": 0, "eg2d": newton + BE_EG_PER_STEP * len(infos_b), "hess2d": len(infos_b),
        "prox3d": 0})
    say(f"backward Euler: K3 launches {launched_b['hess2d']} = steps {len(infos_b)}; "
        f"K2 launches {launched_b['eg2d']} = Newton iterations {newton} + "
        f"{BE_EG_PER_STEP} x {len(infos_b)} steps")
    card_vs_cpu(1)
    card_vs_cpu(2)
    launched3 = {}
    for label, (cfg3, integ3, _, _) in box.items():
        t = time.perf_counter()
        infos3, ih3, launched3[label] = drive(f"3D MM-ADMM {label}", cfg3, integ3, STEP_CAP_3D)
        wall = time.perf_counter() - t
        f32_ih0[f"{label} float64"] = (float(integ3.mesh.energy(integ3.mesh.X0)), float(ih3[0]))
        iters3 = sum(i.n_iters for i in infos3)
        expect(label, launched3[label], {"prox2d": 0, "eg2d": 0, "hess2d": 0, "prox3d": iters3})
        say(f"3D MM-ADMM {label}: K4 launches {launched3[label]['prox3d']} = ADMM iterations "
            f"{iters3} over {len(infos3)} steps ({iters3 / len(infos3):.2f} per step), "
            f"{1e3 * wall / len(infos3):.1f} ms per step; Ih trace {[round(float(v), 9) for v in ih3]}")
        check_recorded(label, infos3, ih3)
    card_vs_cpu_3d("3D MM-ADMM at SquareGrid nx=4 (3D stencil engine, K4)",
                   lambda device: box3d("SquareGrid", 1, 4, device)[2])
    launched_s = {}
    for label, entry in stock.items():
        cfg_s, integ_s = entry[:2]
        t = time.perf_counter()
        infos_s, ih_s, launched_s[label] = drive(f"stock {label}", cfg_s, integ_s,
                                                 STOCK_CAPS[label])
        wall = time.perf_counter() - t
        iters_s = [i.n_iters for i in infos_s]
        kernel = "prox2d" if integ_s.mesh.dim == 2 else "prox3d_chord_comp"
        expect(label, launched_s[label], {kernel: sum(iters_s)})
        say(f"stock {label}: {kernel} launches {launched_s[label][kernel]} = ADMM iterations "
            f"{sum(iters_s)} over {len(infos_s)} steps (per step {iters_s}), "
            f"{1e3 * wall / len(infos_s):.1f} ms per step; Ih trace "
            f"{[round(float(v), 9) for v in ih_s]}")
        if label in RECORDED_3D:
            check_recorded(label, infos_s, ih_s)
        if label in JAX_STEP0_IH:
            ref, ih0 = JAX_STEP0_IH[label], float(ih_s[0])
            if not math.isclose(ih0, ref, rel_tol=1e-6):
                raise AssertionError(f"{label}: step-0 Ih {ih0!r} vs the JAX package's "
                                     f"{ref!r}, outside rtol 1e-6")
            say(f"stock {label}: step-0 Ih {ih0!r} within rtol 1e-6 of the JAX package's "
                f"{ref!r} (rel {abs(ih0 / ref - 1):.2e})")
    card_vs_cpu_3d("3D MM-ADMM at CompSquare nx=4 (stock engine, K4')",
                   lambda device: comp_square(4, device)[2])
    launched_g = {}
    for label, make in (
            ("Monitor3320r float64", lambda: monitor3320r(as_loaded=True)),
            ("3D CompSquare-40 float64", lambda: comp_square(40, dtype="float64")),
            ("3D CompSquare-20 float64", lambda: comp_square(20, dtype="float64")),
            ("LevelSet-320 float64", lambda: generic("LevelSet", 320)),
            ("2D CompSquare-320 float32", lambda: generic("SquareGrid", 320, mon_type=5,
                                                          rho=10.0, comp_mesh=True,
                                                          dtype="float32"))):
        t = time.perf_counter()
        cfg_g, mesh_g, integ_g = make()
        say(f"{label} set-up: {mesh_g.n_pnts} nodes, {mesh_g.n_elements} elements, "
            f"{type(integ_g).__name__}, prox {mesh_g.prox_backend}, {mesh_g.dtype}, j_carry "
            f"{integ_g.j_carry}, jac_batch {mesh_g.jac_batch} ({time.perf_counter() - t:.2f} s)")
        if mesh_g.prox_backend != "vmap" or type(integ_g).__name__ != "ADMMIntegrator":
            raise AssertionError(f"{label}: not the stock engine on the generic route")
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        infos_g, ih_g, launched_g[label] = drive(f"generic {label}", cfg_g, integ_g,
                                                 GENERIC_CAPS[label])
        wall = time.perf_counter() - t
        if label.startswith("LevelSet") and not all(b < a for a, b in zip(ih_g, ih_g[1:])):
            raise AssertionError(f"{label}: I_h does not fall at every step: {list(ih_g)}")
        expect(label, launched_g[label], {})
        say(f"generic {label}: {len(infos_g)} steps, ADMM iterations per step "
            f"{[i.n_iters for i in infos_g]}, {1e3 * wall / len(infos_g):.1f} ms per step, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; Ih trace "
            f"{[float(v) for v in ih_g]}")
        check_jax(label, infos_g)
        if label.startswith("Monitor3320r"):  # step 0 again, on warm caches
            state = integ_g.init_state()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, info = integ_g.step(state)
            torch.cuda.synchronize()
            say(f"{label}: step 0 again from the initial state: {1e3 * (time.perf_counter() - t):.1f}"
                f" ms, Ih {info.ih!r}, {info.n_iters} ADMM iterations")
        del cfg_g, mesh_g, integ_g
    card_vs_cpu_generic("2D SquareGrid nx=8, float64",
                        lambda device: generic("SquareGrid", 8, device, mon_type=1)[2])
    card_vs_cpu_generic("3D CompSquare nx=4, float64",
                        lambda device: comp_square(4, device, dtype="float64")[2])
    launched_k, k4pp = {}, {}
    for label, make, kernel, variant in (
            ("K4''a 3D SquareGrid-40", lambda: square_chord(40), "prox3d_chord", "chord"),
            ("K4''b 3D CompSquare-40", lambda: comp_square(40, prox_chord=False), "prox3d_comp",
             "comp")):
        t = time.perf_counter()
        cfg_k, mesh_k, integ_k = make()
        say(f"{label} set-up: {mesh_k.n_elements} tets, {type(integ_k).__name__}, prox "
            f"{mesh_k.prox_backend}, chord {mesh_k.prox_chord} ({time.perf_counter() - t:.2f} s)")
        # the kernel against its plain version on this path's step-0 inputs,
        # which also make its row of the kernels line
        k4pp[kernel] = compare4pp(f"{kernel} vs plain, {label} step 0", integ_k, variant)
        t = time.perf_counter()
        infos_k, ih_k, launched_k[label] = drive(f"stock {label}", cfg_k, integ_k, K4PP_CAP)
        wall = time.perf_counter() - t
        iters_k = [i.n_iters for i in infos_k]
        expect(label, launched_k[label], {kernel: sum(iters_k)})
        say(f"stock {label}: {kernel} launches {launched_k[label][kernel]} = ADMM iterations "
            f"{sum(iters_k)} over {len(infos_k)} steps (per step {iters_k}), "
            f"{1e3 * wall / len(infos_k):.1f} ms per step; Ih trace "
            f"{[round(float(v), 9) for v in ih_k]}")
        if label in RECORDED_3D:
            check_recorded(label, infos_k, ih_k)
        del cfg_k, mesh_k, integ_k
    # the float64 stencil engines, their kernels built in float64
    launched64 = {}
    for label, engine in (("MM-ADMM float64", "GridADMM2D"), ("Euler float64", "EulerIntegrator"),
                          ("backward Euler float64", "BackwardEulerIntegrator"),
                          ("3D Shoulder-40 float64", "SoAADMM3D"),
                          ("3D SquareGrid-40 float64", "SoAADMM3D")):
        t = time.perf_counter()
        infos64, _, launched64[label] = drive_f64(label, *f64[label], engine, f32_ih0[label])
        inner = [getattr(i, "n_iters", getattr(i, "n_newton", None)) for i in infos64]
        say(f"{label}: {len(infos64)} steps, inner iterations per step {inner}, "
            f"{1e3 * (time.perf_counter() - t) / len(infos64):.1f} ms per step")
    for method in (0, 1, 2):
        card_vs_cpu_f64(f"method {method} at Shoulder nx=16 float64",
                        lambda device: shoulder(16, method, device, "float64")[2])
    card_vs_cpu_f64("3D MM-ADMM at SquareGrid nx=4 float64 (3D stencil engine, K4 float64)",
                    lambda device: box3d("SquareGrid", 1, 4, device, "float64")[2])
    # the stock engine on the float64 kernel route: K4', K4''a and K4''b
    # built in float64
    launched64s, k4_64s = {}, {}
    for label, name, ref_label, jax_steps in F64_STOCK:
        t = time.perf_counter()
        cfg_k, mesh_k, integ_k = f64_stock(label, 20 if "-20" in label else 40)
        say(f"{label} set-up: {mesh_k.n_elements} tets, {type(integ_k).__name__}, prox "
            f"{mesh_k.prox_backend}, chord {mesh_k.prox_chord}, {mesh_k.dtype} "
            f"({time.perf_counter() - t:.2f} s)")
        if (type(integ_k).__name__ != "ADMMIntegrator" or mesh_k.prox_backend != "pallas"
                or mesh_k.dtype != torch.float64):
            raise AssertionError(f"{label}: not the stock engine on the float64 kernel route")
        # the kernel against its plain version on this path's step-0 inputs,
        # which also make its row of the kernels line (the -40 paths')
        call = stock_call(integ_k)
        k4_64s[label] = (name, call, *compare_f64(f"{name} float64 vs plain, {label} step 0",
                                                  _wrappers()[name],
                                                  getattr(P3, f"{name}_plain"), *call))
        t = time.perf_counter()
        infos_k, ih_k, launched64s[label] = drive(label, cfg_k, integ_k, F64_CAP)
        wall = time.perf_counter() - t
        iters_k = [i.n_iters for i in infos_k]
        expect(label, launched64s[label], {f"{name}_f64": sum(iters_k)})
        say(f"{label}: {name}_f64 launches {launched64s[label][f'{name}_f64']} = ADMM iterations "
            f"{sum(iters_k)} over {len(infos_k)} steps (per step {iters_k}), float32 kernels 0, "
            f"{1e3 * wall / len(infos_k):.1f} ms per step; Ih trace {[float(v) for v in ih_k]}")
        if ref_label is not None:
            check_jax_f64(label, infos_k, ref_label, jax_steps)
        del cfg_k, mesh_k, integ_k
    for label, _, _, _ in F64_STOCK[1:]:
        card_vs_cpu_f64(f"3D MM-ADMM at {label.replace('-40', '')} nx=4 (stock engine, kernel "
                        f"route)", lambda device, label=label: f64_stock(label, 4, device)[2])
    # explicit and backward Euler on the compact path (no kernel)
    name = {1: "explicit Euler", 2: "backward Euler"}
    for method in (1, 2):
        for label, make in (
                ("3D Shoulder-40", lambda: box3d("Shoulder", 0, 40, method=method)),
                ("3D SquareGrid-40", lambda: box3d("SquareGrid", 1, 40, method=method)),
                ("3D CompSquare-40", lambda: comp_square(40, method=method))):
            drive_compact(f"{name[method]} {label}", make, COMPACT_CAPS[method])
        label = f"{name[method]} Monitor3320r float64"
        infos_c = drive_compact(label, lambda: monitor3320r(as_loaded=True, method=method), 10)
        check_jax_compact(label, method, infos_c)
        card_vs_cpu_f64(f"{name[method]} at 3D SquareGrid nx=4 float64 (compact path)",
                        lambda device: box3d("SquareGrid", 1, 4, device, "float64", method)[2])

    # ---- timing --------------------------------------------------------------
    z, dxpu, free, cells = inputs
    args = (integ.mesh.ehat_np.reshape(-1), integ.w, integ.prox_tol, integ.prox_max_iters)
    stats = {}
    rows = []

    def row(name, source, replaces, launches, err, t, plain_ms, b, f64=False):
        """A kernel's row; ``t`` is ``times(...)``: ``ms`` a call through
        the wrapper, as a path pays it, ``device_ms`` a launch of the bare C
        entry."""
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": t[0], "device_ms": t[1],
            "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
        })
        say(f"{name}: {shown(t)}; plain {plain_ms:.1f} ms; bound {b[0]:.4f} ms by {b[1]} "
            f"({b[2]:.4e} operations at {'33.5' if f64 else '67'} TFLOP/s, {b[3]} bytes at "
            f"3.35 TB/s), the C entry at {100 * b[0] / t[1]:.1f} % of it")

    n = z.shape[1]
    row("prox2d", "mmadmm_tpu_torch/csrc/prox2d.cu", "mmadmm_tpu/ops/prox_pallas2d.py:573",
        launched["prox2d"] + launched_s["Monitor3320r"]["prox2d"], k1_err,
        times(P, lambda: P.prox2d(z, dxpu, free, cells, *args)),
        time_plain(lambda: P.prox2d_plain(z, dxpu, free, cells, *args)),
        bound(lambda: P.prox2d_plain(z, dxpu, free, cells, *args, stats=stats),
              n * (6 + 6 + 6 + 48 + 6 + 1)))
    k1_work("K1 step-0 work at Shoulder-320", inputs, args, stats)
    zb, cb, eh = be_in
    row("eg2d", "mmadmm_tpu_torch/csrc/be2d.cu", "mmadmm_tpu/ops/prox_pallas2d.py:501",
        launched_e["eg2d"] + launched_b["eg2d"], k2_err,
        times(B, lambda: B.eg2d(zb, cb, eh)),
        time_plain(lambda: B.eg2d_plain(zb, cb, eh)),
        bound(lambda: B.eg2d_plain(zb, cb, eh), n * (6 + 48 + 6 + 1)))
    say(f"K3 launches with the block {B.hess_block(torch.float32)} in float32, "
        f"{B.hess_block(torch.float64)} in float64")
    row("hess2d", "mmadmm_tpu_torch/csrc/be2d.cu", "mmadmm_tpu/ops/prox_pallas2d.py:514",
        launched_b["hess2d"], k3_err,
        times(B, lambda: B.hess2d(zb, cb, eh)),
        time_plain(lambda: B.hess2d_plain(zb, cb, eh)),
        bound(lambda: B.hess2d_plain(zb, cb, eh), n * (6 + 48 + 21)))
    ptimes = {}
    per_elem4 = 12 + 12 + 12 + 216 + 12 + 1
    for label, (_, integ3, err, (z3, d3, f3, c3)) in box.items():
        a3 = (integ3.mesh.ehat_np.reshape(-1), integ3.w, integ3.prox_tol, integ3.prox_max_iters)
        ptimes[label] = (err, times(P3, lambda: P3.prox3d(z3, d3, f3, c3, *a3)),
                         time_plain(lambda: P3.prox3d_plain(z3, d3, f3, c3, *a3)))
        say(f"K4 at {label} step 0: {shown(ptimes[label][1])}; plain "
            f"{ptimes[label][2]:.1f} ms")
    # K4's bound at 3D SquareGrid-40 step 0 (its row is Shoulder-40's)
    _, integ3, _, (z3, d3, f3, c3) = box["3D SquareGrid-40"]
    a3 = (integ3.mesh.ehat_np.reshape(-1), integ3.w, integ3.prox_tol, integ3.prox_max_iters)
    stats_sq = {}
    b_sq = bound(lambda: P3.prox3d_plain(z3, d3, f3, c3, *a3, stats=stats_sq),
                 z3.shape[1] * per_elem4)
    say(f"K4 bound at 3D SquareGrid-40 step 0: {b_sq[0]:.4f} ms by {b_sq[1]} ({b_sq[2]:.4e} "
        f"operations at 67 TFLOP/s, {b_sq[3]} bytes at 3.35 TB/s); {work(stats_sq)}")
    # K4's row: the 3D Shoulder-40 step-0 inputs (672,000 live tets in 768,000 slots)
    _, integ3, _, (z3, d3, f3, c3) = box["3D Shoulder-40"]
    a3 = (integ3.mesh.ehat_np.reshape(-1), integ3.w, integ3.prox_tol, integ3.prox_max_iters)
    stats3 = {}
    err3, ms3, plain3 = ptimes["3D Shoulder-40"]
    row("prox3d", "mmadmm_tpu_torch/csrc/prox3d.cu", "mmadmm_tpu/ops/prox_pallas3d.py:263",
        sum(v["prox3d"] for v in launched3.values()), err3, ms3, plain3,
        bound(lambda: P3.prox3d_plain(z3, d3, f3, c3, *a3, stats=stats3),
              z3.shape[1] * per_elem4))
    say(f"K4 step-0 work at 3D Shoulder-40: {work(stats3)}")
    # K1 on Monitor3320r's step-0 inputs, through the stock engine's entry
    m_integ, m_err, m_in = stock["Monitor3320r"][1:]
    m_args = (m_integ.mesh.ehat_np.reshape(-1), m_integ.w, m_integ.prox_tol,
              m_integ.prox_max_iters)
    stats_m = {}
    m_ms = times(P, lambda: P.prox2d(*m_in, *m_args))
    m_plain = time_plain(lambda: P.prox2d_plain(*m_in, *m_args))
    m_bound = bound(lambda: P.prox2d_plain(*m_in, *m_args, stats=stats_m),
                    m_in[0].shape[1] * (6 + 6 + 6 + 48 + 6 + 1))
    say(f"K1 at Monitor3320r step 0 ({m_in[0].shape[1]} triangles): {shown(m_ms)}; plain "
        f"{m_plain:.1f} ms; bound {m_bound[0]:.4f} ms by {m_bound[1]} "
        f"({m_bound[2]:.4e} operations, {m_bound[3]} bytes); {work(stats_m)}")
    # K4' on CompSquare-20's step-0 inputs, then its row on CompSquare-40's
    per_elem4c = 12 + 12 + 12 + 216 + 9 + 12 + 1
    i20, _, c20 = stock["3D CompSquare-20"][1:]
    a20 = (i20.w, i20.prox_tol, i20.prox_max_iters)
    stats20 = {}
    ms20 = times(P3, lambda: P3.prox3d_chord_comp(*c20, *a20))
    plain20 = time_plain(lambda: P3.prox3d_chord_comp_plain(*c20, *a20))
    b20 = bound(lambda: P3.prox3d_chord_comp_plain(*c20, *a20, stats=stats20),
                c20[0].shape[1] * per_elem4c)
    say(f"K4' at 3D CompSquare-20 step 0 ({c20[0].shape[1]} tets): {shown(ms20)}; plain "
        f"{plain20:.1f} ms; bound {b20[0]:.4f} ms by {b20[1]} ({b20[2]:.4e} "
        f"operations, {b20[3]} bytes); {work(stats20)}")
    i40, err40, c40 = stock["3D CompSquare-40"][1:]
    a40 = (i40.w, i40.prox_tol, i40.prox_max_iters)
    stats4 = {}
    row("prox3d_chord_comp", "mmadmm_tpu_torch/csrc/prox3d.cu",
        "mmadmm_tpu/ops/prox_pallas3d.py:418",
        sum(launched_s[k]["prox3d_chord_comp"] for k in ("3D CompSquare-20", "3D CompSquare-40")),
        err40, times(P3, lambda: P3.prox3d_chord_comp(*c40, *a40)),
        time_plain(lambda: P3.prox3d_chord_comp_plain(*c40, *a40)),
        bound(lambda: P3.prox3d_chord_comp_plain(*c40, *a40, stats=stats4),
              c40[0].shape[1] * per_elem4c))
    say(f"K4' step-0 work at 3D CompSquare-40: {work(stats4)}")
    for name, label in (("prox3d_chord", "K4''a 3D SquareGrid-40"),
                        ("prox3d_comp", "K4''b 3D CompSquare-40")):
        err, (kernel, plain, inputs_p, args_p) = k4pp[name]
        stats_p = {}
        per_elem = 12 + 12 + 12 + 216 + (9 if name == "prox3d_comp" else 0) + 12 + 1
        row(name, "mmadmm_tpu_torch/csrc/prox3d.cu", "mmadmm_tpu/ops/prox_pallas3d.py:418",
            launched_k[label][name], err,
            times(P3, lambda: kernel(*inputs_p, *args_p)),
            time_plain(lambda: plain(*inputs_p, *args_p)),
            bound(lambda: plain(*inputs_p, *args_p, stats=stats_p),
                  inputs_p[0].shape[1] * per_elem))
        say(f"{name} step-0 work at {inputs_p[0].shape[1]} tets: {work(stats_p)}")
    # the float64 builds: K1-K3 on Shoulder-320's float64 step-0 inputs, K4
    # on 3D Shoulder-40's (its row) and 3D SquareGrid-40's
    z64, d64, f64_, c64 = k1_64[0]
    a64 = k1_64[1]
    stats = {}
    row("prox2d_f64", "mmadmm_tpu_torch/csrc/prox2d.cu", "mmadmm_tpu/ops/prox_pallas2d.py:573",
        launched64["MM-ADMM float64"]["prox2d_f64"], k1_64_err,
        times(P, lambda: P.prox2d(z64, d64, f64_, c64, *a64)),
        time_plain(lambda: P.prox2d_plain(z64, d64, f64_, c64, *a64)),
        bound(lambda: P.prox2d_plain(z64, d64, f64_, c64, *a64, stats=stats),
              z64.shape[1] * (6 + 6 + 6 + 48 + 6 + 1), f64=True), f64=True)
    k1_work("K1 float64 step-0 work at Shoulder-320 float64", k1_64[0], a64, stats)
    row("eg2d_f64", "mmadmm_tpu_torch/csrc/be2d.cu", "mmadmm_tpu/ops/prox_pallas2d.py:501",
        launched64["Euler float64"]["eg2d_f64"] + launched64["backward Euler float64"]["eg2d_f64"],
        k2_64_err, times(B, lambda: B.eg2d(zb64, cb64, eh64)),
        time_plain(lambda: B.eg2d_plain(zb64, cb64, eh64)),
        bound(lambda: B.eg2d_plain(zb64, cb64, eh64), zb64.shape[1] * (6 + 48 + 6 + 1),
              f64=True), f64=True)
    row("hess2d_f64", "mmadmm_tpu_torch/csrc/be2d.cu", "mmadmm_tpu/ops/prox_pallas2d.py:514",
        launched64["backward Euler float64"]["hess2d_f64"], k3_64_err,
        times(B, lambda: B.hess2d(zb64, cb64, eh64)),
        time_plain(lambda: B.hess2d_plain(zb64, cb64, eh64)),
        bound(lambda: B.hess2d_plain(zb64, cb64, eh64), zb64.shape[1] * (6 + 48 + 21),
              f64=True), f64=True)
    for label in ("3D SquareGrid-40 float64", "3D Shoulder-40 float64"):
        (inp, a4), err, plain_s = k4_64[label]
        ms = times(P3, lambda: P3.prox3d(*inp, *a4))
        if label == "3D SquareGrid-40 float64":
            stats_sq = {}
            b_sq = bound(lambda: P3.prox3d_plain(*inp, *a4, stats=stats_sq),
                         inp[0].shape[1] * per_elem4, f64=True)
            say(f"K4 float64 at {label} step 0: {shown(ms)}; plain {1e3 * plain_s:.1f} ms; "
                f"bound {b_sq[0]:.4f} ms by {b_sq[1]} ({b_sq[2]:.4e} "
                f"operations at 33.5 TFLOP/s, {b_sq[3]} bytes at 3.35 TB/s); {work(stats_sq)}")
            continue
        stats64 = {}
        row("prox3d_f64", "mmadmm_tpu_torch/csrc/prox3d.cu",
            "mmadmm_tpu/ops/prox_pallas3d.py:263",
            sum(launched64[k]["prox3d_f64"] for k in ("3D Shoulder-40 float64",
                                                      "3D SquareGrid-40 float64")),
            err, ms, time_plain(lambda: P3.prox3d_plain(*inp, *a4)),
            bound(lambda: P3.prox3d_plain(*inp, *a4, stats=stats64),
                  inp[0].shape[1] * per_elem4, f64=True), f64=True)
        say(f"K4 float64 step-0 work at {label}: {work(stats64)}")
    # K4', K4''a and K4''b in float64: K4' on CompSquare-20's step-0 inputs on
    # a line of its own, each row on its -40 path's
    for label, (name, (inp, a4), err, plain_s) in k4_64s.items():
        kernel, plain = _wrappers()[name], getattr(P3, f"{name}_plain")
        ms = times(P3, lambda: kernel(*inp, *a4))
        stats_p = {}
        per_elem = 12 + 12 + 12 + 216 + (0 if name == "prox3d_chord" else 9) + 12 + 1
        if "-20" in label:
            b = bound(lambda: plain(*inp, *a4, stats=stats_p), inp[0].shape[1] * per_elem,
                      f64=True)
            say(f"{name} float64 at {label} step 0 ({inp[0].shape[1]} tets): {shown(ms)}; plain "
                f"{1e3 * plain_s:.1f} ms; bound {b[0]:.4f} ms by {b[1]} "
                f"({b[2]:.4e} operations at 33.5 TFLOP/s, {b[3]} bytes at 3.35 TB/s); "
                f"{work(stats_p)}")
            continue
        row(f"{name}_f64", "mmadmm_tpu_torch/csrc/prox3d.cu",
            "mmadmm_tpu/ops/prox_pallas3d.py:418",
            sum(v[f"{name}_f64"] for v in launched64s.values()), err, ms,
            time_plain(lambda: plain(*inp, *a4)),
            bound(lambda: plain(*inp, *a4, stats=stats_p), inp[0].shape[1] * per_elem,
                  f64=True), f64=True)
        say(f"{name} float64 step-0 work at {label}: {work(stats_p)}")
    say(f"launches by path: MM-ADMM {launched}, Euler {launched_e}, backward Euler {launched_b}, "
        f"3D MM-ADMM {launched3}, stock engine {launched_s}, generic route {launched_g}, "
        f"K4'' {launched_k}, float64 stencil engines {launched64}, float64 kernel route "
        f"{launched64s}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mmadmm_tpu_torch import cuda_build
    from mmadmm_tpu_torch.ops import be2d as B
    from mmadmm_tpu_torch.ops import prox2d as P
    from mmadmm_tpu_torch.ops import prox3d as P3

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"device: {kind}; {smi}; max SM clock {clock} (the peak rates' clock); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # ---- build ---------------------------------------------------------------
    t = time.perf_counter()
    cuda_build.build(["prox2d", "be2d", "prox3d"])
    P.library()
    B.library()
    P3.library()
    say(f"build: prox2d, be2d and prox3d (K4, K4' and K4'') together in "
        f"{time.perf_counter() - t:.2f} s")
    for name in ("prox2d", "be2d", "prox3d"):
        for line in cuda_build.ptxas_report(name).splitlines():
            say(f"ptxas {name}: {line.strip()}")
    say("resident on each SM (occupancy calculator): " + "; ".join(
        f"{entry} {b} blocks of {t} threads = {b * t // 32} warps"
        for entry, (b, t) in P3.residency().items()))

    rows = kernel_and_path_phases()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"handed back before the harness phases: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"still allocated")
    launched_h = harness_phases()
    say(f"launches by harness path: {launched_h}")
    launched_h["ranks"] = sharded_phase()
    row_of = {r["name"]: r for r in rows}
    for name in ("prox3d_f64", "prox2d", "prox3d_chord_comp_f64"):
        row_of[name]["launches"] += sum(v.get(name, 0) for v in launched_h.values())
    print(json.dumps({"kernels": rows}), flush=True)
    say(f"all phases passed in {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
