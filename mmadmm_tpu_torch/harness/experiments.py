"""Experiment sweep workflows (port of
``mmadmm_tpu/harness/experiments.py``).

The reference's ``experiments.py`` entry points (``run_scale_experiment``
``:503-541``, ``run_parallel_experiment`` ``:435-468``,
``plot_energy_decrease`` ``:209-283``) as library functions:

* ``run_method_comparison``: methods 0/1/2 on one config, wall times and
  traces (the reference's ``Single<cfg>.json`` artifact),
* ``run_device_scaling``: a sweep of device counts (the reference swept
  OpenMP threads 1..32; ``Para<cfg>.json``), one card until multi-GPU
  runs are ported (ROADMAP item A15),
* ``run_grid_scale`` and ``run_simultaneous_experiment``: sweeps over the
  ``<name><n>.json`` configs of a directory,
* ``make_config_json``: a reference-schema config file,
* ``compare_to_reference``: a shipped ``Ih<m>.txt`` trace against a run,
  step by step.

``run_kw`` passes through to ``runner.run_experiment`` (``device``,
``base_dir``, ``verbose``, ...). Bare config names resolve against this
repository's ``Experiments/`` tree (``INPUTS``, ``RESULTS``).
"""

from __future__ import annotations

import glob
import json
import os
import re

import numpy as np

from ..config import load_experiment_config
from .runner import run_experiment

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
INPUTS = os.path.join(_ROOT, "Experiments", "InputFiles")
RESULTS = os.path.join(_ROOT, "Experiments", "Results")


def run_method_comparison(
    cfg_path: str,
    out_dir: str | None = None,
    methods=(0, 1, 2),
    n_repeats: int = 1,
    **run_kw,
) -> dict:
    """Single-config method timing comparison (experiments.py:503-541)."""
    results: dict = {"config": cfg_path, "methods": {}}
    for m in methods:
        times, finals, steps = [], [], []
        for _ in range(n_repeats):
            cfg = load_experiment_config(cfg_path, method=m)
            res = run_experiment(
                cfg,
                out_dir=os.path.join(out_dir, f"method{m}") if out_dir else None,
                **run_kw,
            )
            times.append(res.loop_time)
            finals.append(res.final_ih)
            steps.append(res.n_steps)
        results["methods"][str(m)] = {
            "mean_time": float(np.mean(times)),
            "times": times,
            "final_ih": finals[-1],
            "n_steps": steps[-1],
            "n_elements": res.n_elements,
        }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "Single.json"), "w") as f:
            json.dump(results, f, indent=2)
    return results


def run_device_scaling(
    cfg_path: str,
    device_counts=(1,),
    out_dir: str | None = None,
    n_repeats: int = 1,
    **run_kw,
) -> dict:
    """Device-count scaling sweep, the reference's OpenMP thread sweep
    (experiments.py:435-468) mapped to device counts. One card only: a
    count above 1 raises before anything runs."""
    if any(int(nd) > 1 for nd in device_counts):
        raise NotImplementedError(
            "device scaling over more than one card needs multi-GPU runs (ROADMAP item A15)"
        )
    results: dict = {"config": cfg_path, "devices": {}}
    for nd in device_counts:
        times = []
        for _ in range(n_repeats):
            cfg = load_experiment_config(cfg_path)
            cfg.n_devices = nd
            res = run_experiment(cfg, out_dir=None, **run_kw)
            times.append(res.loop_time)
        results["devices"][str(nd)] = {
            "mean_time": float(np.mean(times)),
            "times": times,
            "steps_per_s": res.n_steps / float(np.mean(times)),
        }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "Para.json"), "w") as f:
            json.dump(results, f, indent=2)
    return results


def make_config_json(
    out_path: str,
    *,
    dim: int = 2,
    test_type: str = "SquareGrid",
    mon_type: int = 0,
    comp_mesh: bool = False,
    boundary_type: int = 1,
    grad_use: bool = False,
    n_steps: int = 1000,
    admm_iter: int = 200,
    dt_tol: float = 1e-5,
    dt: float = 5e-3,
    tau: float = 0.1,
    rho: float = 50.0,
    w: float = 0.0,
    nx: int = 20,
    ny: int | None = None,
    nz: int | None = None,
    bounds=(0.0, 1.0, 0.0, 1.0, 0.0, 1.0),
    extra: dict | None = None,
) -> str:
    """Write a reference-schema experiment JSON (the analogue of the
    reference's string templates and ``create_input_from_dict``,
    ``experiments.py:36-88``). Returns ``out_path``."""
    xa, xb, ya, yb, za, zb = bounds
    data: dict = {
        "TestType": test_type,
        "Dim": dim,
        "MonType": mon_type,
        "Method": 0,
        "CompMesh": comp_mesh,
        "BoundaryType": boundary_type,
        "GradUse": grad_use,
        "nSteps": n_steps,
        "AdmmIter": admm_iter,
        "DtTol": dt_tol,
        "dt": dt,
        "tau": tau,
        "rho": rho,
        "w": w,
        "nx": nx,
        "ny": nx if ny is None else ny,
        "xa": xa,
        "xb": xb,
        "ya": ya,
        "yb": yb,
    }
    if dim == 3:
        data.update({"nz": nx if nz is None else nz, "za": za, "zb": zb})
    if extra:
        data.update(extra)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(data, f, indent=4)
    return out_path


def _sized_configs(input_dir: str, test_name: str) -> list:
    """``[(n, path)]`` of the ``<test_name><n>.json`` files, sorted by n."""
    paths = []
    for p in glob.glob(os.path.join(input_dir, f"{test_name}*.json")):
        m = re.match(rf"{re.escape(test_name)}(\d+)\.json$", os.path.basename(p))
        if m:
            paths.append((int(m.group(1)), p))
    return sorted(paths)


def run_grid_scale(
    input_dir: str,
    test_name: str,
    out_dir: str | None = None,
    methods=(0, 1, 2),
    **run_kw,
) -> dict:
    """Grid-size scale sweep: run every ``<test_name><n>.json`` under
    ``input_dir`` (sorted by n) for each method, recording wall times: the
    reference's ``run_scale_experiment`` (``experiments.py:503-541``,
    which globs InputFiles and dumps ``Data/<name>/Single<cfg>.json``)."""
    results: dict = {"test_name": test_name, "configs": {}}
    for n, p in _sized_configs(input_dir, test_name):
        comp = run_method_comparison(
            p,
            out_dir=os.path.join(out_dir, f"{test_name}{n}") if out_dir else None,
            methods=methods,
            **run_kw,
        )
        results["configs"][str(n)] = comp["methods"]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"Scale{test_name}.json"), "w") as f:
            json.dump(results, f, indent=2)
    return results


def run_simultaneous_experiment(
    input_dir: str,
    test_name: str,
    out_dir: str | None = None,
    n_repeats: int = 3,
    highest_pow: int = 0,
    **run_kw,
) -> dict:
    """Matched size/parallelism sweep (``run_simultaneous_experiment``,
    ``experiments.py:470-501``): the i-th config ``<test_name><n>.json``
    (sorted by n) runs MM-ADMM on 2^min(i, highest_pow) devices,
    ``n_repeats`` times (the reference paired growing grids with growing
    OpenMP thread counts). Dumps one ``Simul<cfg>.json`` per config in the
    reference's ``{"(i, pow)": [times...]}`` shape. One card until
    multi-GPU runs are ported: ``highest_pow`` above 0 raises (ROADMAP
    item A15)."""
    if highest_pow > 0:
        raise NotImplementedError(
            "a sweep over more than one card needs multi-GPU runs (ROADMAP item A15)"
        )
    pows = [2**i for i in range(highest_pow + 1)]
    results: dict = {"test_name": test_name, "configs": {}}
    for i, (n, p) in enumerate(_sized_configs(input_dir, test_name)):
        nd = pows[min(i, highest_pow)]
        times = []
        for _ in range(n_repeats):
            cfg = load_experiment_config(p)
            cfg.n_devices = nd
            res = run_experiment(cfg, out_dir=None, **run_kw)
            times.append(res.loop_time)
        key = f"({i}, {nd})"
        results["configs"][f"{test_name}{n}"] = {key: times}
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"Simul{test_name}{n}.json"), "w") as f:
                json.dump({key: times}, f)
    return results


def load_reference_trace(name: str, method: int = 0, results_dir: str = RESULTS) -> np.ndarray:
    """Rows of ``(wall_s, Ih)`` of a recorded ``<results_dir>/<name>/Ih<method>.txt``."""
    path = os.path.join(results_dir, name, f"Ih{method}.txt")
    return np.loadtxt(path, delimiter=",", ndmin=2)


def compare_to_reference(res, name: str, method: int = 0, results_dir: str = RESULTS) -> dict:
    """Step-wise parity report of a RunResult against a recorded trace."""
    ref = load_reference_trace(name, method, results_dir)[:, 1]
    ours = np.asarray(res.ih_trace)
    n = min(len(ref), len(ours))
    delta = np.abs(ours[:n] - ref[:n])
    rel = delta / np.maximum(np.abs(ref[:n]), 1e-30)
    return {
        "n_compared": int(n),
        "max_rel_delta": float(rel.max()),
        "first_divergence_step": int(np.argmax(rel > 1e-4)) if (rel > 1e-4).any() else -1,
        "final_ours": float(ours[-1]),
        "final_ref": float(ref[-1]),
    }
