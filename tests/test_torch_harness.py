"""The port's experiment harness (``mmadmm_tpu_torch/harness``, the
``geometry/io.py`` writers, ``runtime/profiling.py``, the CLI
``mmadmm_tpu_torch/run.py``) against the JAX package's on the CPU.

* Writers: the same arrays (a numpy seed) give byte-identical files.
* Runner: ``run_experiment`` on the JAX harness tests' ``tiny_cfg``
  (``tests/test_harness.py:20-26``: 2D SquareGrid nx=6, 6 steps, float64)
  for methods 0, 1 and 2, one JAX run each (module-scoped). The same file
  set, ``n_steps`` and ``summary.json`` keys; ``triangles.txt`` and
  ``mask.txt`` byte-identical; the energy trace within the float64 band
  of the port's tests of these routes, rel 1e-10 (the generic route,
  ``tests/test_torch_admm_generic.py``; the compact Euler paths,
  ``tests/test_torch_euler_compact.py`` and ``test_torch_be_compact.py``);
  ``Ih<m>.txt``'s energies and ``points.txt`` within the rounding of their
  6 significant digits (rtol 1e-5).
* Checkpoints: a resume equals the uninterrupted run bit for bit, within
  the port, for every state an integrator carries (``tests/test_harness.py:59``).
* ``output_x`` / ``output_z`` of the stock engine against the JAX
  package's at nx=4 (``tests/test_harness_extras.py:15``), rel 1e-10.
* The CLI with ``--device cpu`` on a JSON written by ``make_config_json``;
  ``Monitor3320r.json`` loads to the same config in both packages; the
  plots render.

No interpreted Pallas compile: the JAX package takes its generic prox and
its compact Euler paths at these sizes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.config import load_experiment_config as jax_load_config
from mmadmm_tpu.geometry import io as jax_io
from mmadmm_tpu.harness import experiments as jax_exps
from mmadmm_tpu.harness.runner import run_experiment as jax_run_experiment

from mmadmm_tpu_torch import ExperimentConfig, build_problem, load_experiment_config
from mmadmm_tpu_torch.geometry import io
from mmadmm_tpu_torch.harness import experiments as exps
from mmadmm_tpu_torch.harness.checkpoint import (
    checkpoint_meta,
    latest_checkpoint,
    resume_experiment,
    save_checkpoint,
)
from mmadmm_tpu_torch.harness.runner import positions, run_experiment
from mmadmm_tpu_torch.run import main as cli_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M3320R = os.path.join(REPO, "Experiments", "InputFiles", "Monitor3320r.json")
TINY = dict(name="tiny", test_type="SquareGrid", dim=2, mon_type=1, nx=6, ny=6, n_steps=6,
            dt=5e-3, tau=0.1, rho=50.0, dt_tol=1e-12)
FILES = {"points.txt", "triangles.txt", "mask.txt", "summary.json"}
IH_RTOL = 1e-10  # the float64 band of the port's tests of these routes
DIGITS_RTOL = 1e-5  # 6 significant digits in the artifacts


def tiny_cfg(cls, method):
    return cls(method=method, **TINY)


def ih_column(path):
    return np.loadtxt(path, delimiter=",", ndmin=2)[:, 1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{method: (jax result, jax dir, port result, port dir)}``."""
    base = tmp_path_factory.mktemp("runs")
    out = {}
    for m in (0, 1, 2):
        jd, pd = str(base / f"jax{m}"), str(base / f"port{m}")
        rj = jax_run_experiment(tiny_cfg(JaxConfig, m), out_dir=jd)
        rp = run_experiment(tiny_cfg(ExperimentConfig, m), out_dir=pd, device="cpu")
        out[m] = (rj, jd, rp, pd)
    return out


def _random_arrays():
    rng = np.random.default_rng(18)
    X = rng.standard_normal((500, 3)) * 10.0 ** rng.integers(-9, 9, size=(500, 3))
    X[0, 0], X[1, 1], X[2, 2], X[3] = -0.0, np.inf, np.nan, [1e300, -1e-310, 0.5]
    return {
        "points64": X,
        "points32": np.clip(X, -1e38, 1e38).astype(np.float32)[:, :2],
        "triangles": rng.integers(0, 2**31 - 1, size=(700, 4)).astype(np.int32),
        "mask": rng.integers(0, 3, size=333).astype(np.int8),
        "trace": (np.cumsum(rng.random(40)), rng.random(40) * 10.0 ** rng.integers(-5, 5, 40)),
    }


@pytest.mark.parametrize("kind", ["points64", "points32", "triangles", "mask", "trace"])
def test_writers_give_the_jax_package_bytes(kind, tmp_path):
    a = _random_arrays()[kind]
    fn = {"points64": "write_points", "points32": "write_points", "triangles": "write_triangles",
          "mask": "write_mask", "trace": "write_energy_trace"}[kind]
    args = a if kind == "trace" else (a,)
    getattr(jax_io, fn)(str(tmp_path / "jax.txt"), *args)
    getattr(io, fn)(str(tmp_path / "port.txt"), *args)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("m", [0, 1, 2])
def test_runner_writes_the_jax_artifacts(runs, m):
    rj, jd, rp, pd = runs[m]
    assert set(os.listdir(pd)) == set(os.listdir(jd)) == FILES | {f"Ih{m}.txt"}
    assert rp.n_steps == rj.n_steps == 6
    with open(os.path.join(jd, "summary.json")) as f:
        sj = json.load(f)
    with open(os.path.join(pd, "summary.json")) as f:
        sp = json.load(f)
    assert list(sp) == list(sj) and sp["n_steps"] == sj["n_steps"] == 6
    assert (sp["converged"], sp["failed"]) == (sj["converged"], sj["failed"])
    for name in ("triangles.txt", "mask.txt"):
        with open(os.path.join(pd, name), "rb") as fp, open(os.path.join(jd, name), "rb") as fj:
            assert fp.read() == fj.read(), name
    np.testing.assert_allclose(rp.ih_trace, rj.ih_trace, rtol=IH_RTOL, atol=0)
    ihp, ihj = ih_column(os.path.join(pd, f"Ih{m}.txt")), ih_column(os.path.join(jd, f"Ih{m}.txt"))
    assert ihp.shape == ihj.shape == (7,)
    np.testing.assert_allclose(ihp, ihj, rtol=DIGITS_RTOL, atol=0)
    xp, xj = (np.loadtxt(os.path.join(d, "points.txt"), delimiter=",") for d in (pd, jd))
    np.testing.assert_allclose(xp, xj, rtol=DIGITS_RTOL, atol=1e-6)
    # the mesh files read back through the FromFile reader
    X, F, mask = io.read_mesh(*(os.path.join(pd, n) for n in ("triangles.txt", "points.txt",
                                                                "mask.txt")))
    assert X.shape[1] == 2 and F.shape[1] == 3 and mask.shape[0] == X.shape[0]


def _cases():
    """``{case: (config, the integrator's class name)}`` of the resume test."""
    shoulder = dict(test_type="Shoulder", dim=2, mon_type=1, nx=16, ny=16, dt=5e-3, tau=0.1,
                    rho=50.0)
    return {
        "grid2d_f32": (ExperimentConfig(dtype="float32", **shoulder), "GridADMM2D"),
        "soa3d_f64": (ExperimentConfig(test_type="SquareGrid", dim=3, mon_type=1, nx=4, ny=4,
                                       nz=4, dt=5e-3, tau=0.1, rho=50.0), "SoAADMM3D"),
        "stock_j": (tiny_cfg(ExperimentConfig, 0), "ADMMIntegrator"),
        "euler": (tiny_cfg(ExperimentConfig, 1), "EulerIntegrator"),
        "backward_euler": (tiny_cfg(ExperimentConfig, 2), "BackwardEulerIntegrator"),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_checkpoint_resume_bit_exact(case, tmp_path):
    cfg, engine = _cases()[case]
    mesh, integ = build_problem(cfg, device="cpu")
    assert type(integ).__name__ == engine
    state = integ.init_state()
    for _ in range(3):
        state, _ = integ.step(state)
    save_checkpoint(str(tmp_path), cfg, mesh, state, 3, 0.25)
    path = latest_checkpoint(str(tmp_path))
    assert checkpoint_meta(path) == (3, 0.25)
    cfg2, _, integ2, state2 = resume_experiment(path, device="cpu")
    assert cfg2 == cfg
    for name, a, b in zip(state._fields, state, state2):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), name
        else:
            assert a == b and type(a) is type(b), name
    for _ in range(2):
        state, i1 = integ.step(state)
        state2, i2 = integ2.step(state2)
        assert i1 == i2
    assert torch.equal(positions(state), positions(state2))


def test_runner_resume_continues_exactly(tmp_path):
    """The CLI's ``--resume`` path: checkpointed at step 3 and resumed, a
    run ends with the uninterrupted run's state and energies."""
    cfg = tiny_cfg(ExperimentConfig, 0)
    full = run_experiment(cfg, out_dir=str(tmp_path / "a"), checkpoint_every=3, device="cpu")
    ckpt = str(tmp_path / "a" / "checkpoints" / "step_000003.npz")
    part = run_experiment(cfg, out_dir=str(tmp_path / "b"), checkpoint_every=3,
                          resume_from=ckpt, device="cpu")
    assert part.n_steps == full.n_steps == 6 and part.ih_trace[1:] == full.ih_trace[4:]
    with np.load(tmp_path / "a" / "checkpoints" / "step_000006.npz") as za, \
            np.load(tmp_path / "b" / "checkpoints" / "step_000006.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert np.array_equal(za[k], zb[k]), k


def test_output_x_and_z_match_jax(tmp_path):
    kw = dict(test_type="SquareGrid", dim=2, mon_type=1, method=0, nx=4, ny=4, dt=5e-3,
              tau=0.1, rho=50.0, prox_backend="vmap")
    from mmadmm_tpu.problems import build_problem as jax_build

    jmesh, jinteg = jax_build(JaxConfig(**kw))
    js, _ = jinteg.step(jinteg.init_state())
    mesh, integ = build_problem(ExperimentConfig(**kw), device="cpu")
    assert type(integ).__name__ == "ADMMIntegrator"
    s, _ = integ.step(integ.init_state())
    for fn, rows in (("output_x", mesh.n_pnts), ("output_z", mesh.n_elements * 3)):
        a = np.genfromtxt(getattr(integ, fn)(s, str(tmp_path / f"{fn}.txt")), delimiter=",")
        b = np.genfromtxt(getattr(jinteg, fn)(js, str(tmp_path / f"jax_{fn}.txt")), delimiter=",")
        assert a.shape == b.shape == (rows, 2)
        np.testing.assert_allclose(a, b, rtol=IH_RTOL, atol=1e-14)
    x = np.genfromtxt(tmp_path / "output_x.txt", delimiter=",")
    np.testing.assert_array_equal(x, s.x.numpy())  # %.17g round-trips a double


def test_cli_writes_the_artifacts(runs, tmp_path):
    """``python -m mmadmm_tpu_torch.run <json> 0 --device cpu --out D`` on
    the tiny config as a user writes it: the runner's artifacts, its
    energies equal to the runner's, the mesh files the JAX package's."""
    path = exps.make_config_json(str(tmp_path / "Tiny6.json"), mon_type=1, n_steps=6,
                                 admm_iter=10, dt_tol=1e-12, nx=6)
    out = str(tmp_path / "out")
    assert cli_main([path, "0", "--device", "cpu", "--out", out]) == 0
    rj, jd, rp, pd = runs[0]
    assert set(os.listdir(out)) == FILES | {"Ih0.txt"}
    np.testing.assert_array_equal(ih_column(os.path.join(out, "Ih0.txt")),
                                  ih_column(os.path.join(pd, "Ih0.txt")))
    for name in ("triangles.txt", "mask.txt", "points.txt"):
        with open(os.path.join(out, name), "rb") as f, open(os.path.join(pd, name), "rb") as g:
            assert f.read() == g.read(), name
    with open(os.path.join(out, "summary.json")) as f:
        s = json.load(f)
    assert s["name"] == "Tiny6" and s["n_steps"] == 6 and s["method"] == 0


def test_cli_rejects_a_missing_config(tmp_path, capsys):
    assert cli_main([str(tmp_path / "NoSuchConfig"), "--device", "cpu"]) == 2
    assert "config not found" in capsys.readouterr().err


def test_make_config_json_writes_the_jax_file(tmp_path):
    kw = dict(dim=3, test_type="Shoulder", mon_type=0, nx=80, dt=5e-3, tau=0.1, rho=50.0)
    a = exps.make_config_json(str(tmp_path / "port" / "S.json"), **kw)
    b = jax_exps.make_config_json(str(tmp_path / "jax" / "S.json"), **kw)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert dataclasses.asdict(load_experiment_config(a)) == dataclasses.asdict(jax_load_config(b))


def test_monitor3320r_loads_as_in_the_jax_package():
    port, jax = load_experiment_config(M3320R), jax_load_config(M3320R)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    assert port.base_dir == REPO and port.dtype == "float64"


def test_sweeps_and_reference_compare(runs, tmp_path):
    """``run_grid_scale`` over two sized configs, ``run_method_comparison``
    and ``run_device_scaling`` on one card, ``compare_to_reference``
    against a recorded trace."""
    ind = str(tmp_path / "inputs")
    for n in (4, 6):
        exps.make_config_json(os.path.join(ind, f"Tiny{n}.json"), mon_type=1, n_steps=2,
                              nx=n, dt_tol=1e-12, admm_iter=10)
    out = exps.run_grid_scale(ind, "Tiny", out_dir=str(tmp_path / "data"), methods=(1,),
                              device="cpu")
    assert set(out["configs"]) == {"4", "6"}
    assert out["configs"]["6"]["1"]["n_steps"] == 2
    assert out["configs"]["6"]["1"]["n_elements"] == 4 * 36
    assert os.path.exists(tmp_path / "data" / "ScaleTiny.json")
    sim = exps.run_simultaneous_experiment(ind, "Tiny", out_dir=str(tmp_path / "sim"),
                                           n_repeats=1, device="cpu")
    assert list(sim["configs"]["Tiny6"]) == ["(1, 1)"]
    para = exps.run_device_scaling(os.path.join(ind, "Tiny4.json"), device="cpu")
    assert set(para["devices"]) == {"1"}
    with pytest.raises(NotImplementedError, match="A15"):
        exps.run_device_scaling(os.path.join(ind, "Tiny4.json"), device_counts=(1, 2))
    rj, jd, rp, pd = runs[0]
    os.makedirs(tmp_path / "results" / "tiny")
    shutil.copy(os.path.join(jd, "Ih0.txt"), tmp_path / "results" / "tiny" / "Ih0.txt")
    rep = exps.compare_to_reference(rp, "tiny", 0, results_dir=str(tmp_path / "results"))
    assert rep["n_compared"] == 7 and rep["max_rel_delta"] < DIGITS_RTOL
    assert rep["first_divergence_step"] == -1


def test_plots_render(runs, tmp_path):
    pytest.importorskip("matplotlib")
    from mmadmm_tpu_torch.harness import plotting

    rj, jd, rp, pd = runs[0]
    mesh, _ = build_problem(tiny_cfg(ExperimentConfig, 0), device="cpu")
    mesh3, _ = build_problem(ExperimentConfig(test_type="SquareGrid", dim=3, mon_type=1, nx=2,
                                              ny=2, nz=2), device="cpu")
    paths = [
        plotting.plot_mesh_2d(mesh.X0, mesh.F, str(tmp_path / "m.png"), title="tiny"),
        plotting.plot_mesh_3d_boundary(mesh3.X0, mesh3.F, str(tmp_path / "m3.png")),
        plotting.plot_energy_decrease({"port": (rp.t_trace, rp.ih_trace),
                                       "jax": (rj.t_trace, rj.ih_trace)}, str(tmp_path / "e.png")),
        plotting.plot_mesh_animation([mesh.X0, mesh.X0 * 0.9], mesh.F, str(tmp_path / "a.gif")),
        plotting.plot_monitor_contour(np.random.default_rng(1).random((5, 5, 4)),
                                      str(tmp_path / "c.png")),
        plotting.plot_time_vs_simplices(
            {"configs": {"4": {"0": {"n_elements": 64, "mean_time": 0.1}},
                         "6": {"0": {"n_elements": 144, "mean_time": 0.2}}}},
            str(tmp_path / "s.png")),
        plotting.plot_scaling({"devices": {"1": {"mean_time": 1.0}, "2": {"mean_time": 0.6}}},
                              str(tmp_path / "p.png")),
        plotting.plot_boundary_points(mesh.X0, mesh.mask_np, str(tmp_path / "b.png")),
    ]
    assert all(os.path.getsize(p) > 0 for p in paths)


def test_phase_timers_and_trace(tmp_path):
    from mmadmm_tpu_torch.runtime.profiling import PhaseTimers, trace

    timers = PhaseTimers()
    for _ in range(2):
        with timers.phase("energy", fence=lambda: torch.ones(3)):
            torch.ones(8).sum()
    assert timers.counts["energy"] == 2 and timers.totals["energy"] > 0
    assert "energy" in timers.report() and "(2 calls)" in timers.report()
    with trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0)
    assert any(e.key == "aten::cumsum" for e in prof.key_averages())
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))
