"""The trajectory loop: its DtTol stop against the runner's
(``harness/runner.py``) on a tiny mesh, and what it keeps for the check."""

import dataclasses

import pytest
import torch

from benchmark import inputs, trajectories, window
from benchmark.tests._tiny import one_thread, tiny_cell

# DtTol raised so that the trajectory stops within some ten steps at nx=4
CASES = [("3DMonitor280.euler", 0.02), ("3DMonitor280.admm", 0.025)]


@pytest.mark.parametrize("name,dt_tol", CASES)
def test_dtol_stop_matches_runner(tmp_path, name, dt_tol):
    """From the undisplaced mesh the window's trajectories end at the step
    where the runner's loop ends, with the runner's I_h trace."""
    from mmadmm_tpu_torch import load_experiment_config
    from mmadmm_tpu_torch.harness.runner import run_experiment

    one_thread()
    cell = tiny_cell(tmp_path, name, DtTol=dt_tol)
    cfg = load_experiment_config(cell.config_path, method=cell.traffic["method"])
    res = run_experiment(cfg, device="cpu")
    assert res.converged and 2 < res.n_steps < cfg.n_steps
    _, x0 = inputs.displaced(cell.cfg, 0.0, 1, "cpu")
    _, _, integ, _ = window.build(cell, "cpu")
    seconds = 2.0 * (res.compile_time + res.loop_time) + 0.5
    win = window.run(cell, integ, x0, seconds, 7, cfg.dt, cfg.dt_tol, cfg.n_steps)
    assert win.lengths and set(win.lengths) == {res.n_steps}
    assert [ih for ih, _ in win.infos[:res.n_steps]] == res.ih_trace[1:]
    whole = trajectories.trajectory(integ, x0, res.n_steps + 2, cfg.dt, cfg.dt_tol)
    assert whole["stop"] == res.n_steps and whole["ih"][:res.n_steps] == res.ih_trace[1:]


def test_window_keeps_first_steps_and_a_sample(tmp_path):
    """The kept first steps and the sampled step are copies of the positions
    the steps produced, with the I_h before the sampled step."""
    one_thread()
    cell = tiny_cell(tmp_path, "3DMonitor280.euler")
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, check={
        "first_steps": 2, "sampled_step": [4, 4]}))
    mesh, x0 = inputs.displaced(cell.cfg, 0.04, 11, "cpu")
    cfg, _, integ, _ = window.build(cell, "cpu")
    win = window.run(cell, integ, x0, 0.5, 11, cfg.dt, cfg.dt_tol, cfg.n_steps)
    assert win.steps >= 5 and len(win.first) == 2 and win.sample.index == 4
    state = window.seeded_state(integ, x0)
    xs, ihs = [x0], []
    for _ in range(5):
        state, info = integ.step(state)
        xs.append(state.x)
        ihs.append(info.ih)
    for k in range(2):
        assert torch.equal(win.first[k].x, xs[k + 1]) and win.first[k].ih == ihs[k]
    s = win.sample
    assert torch.equal(s.step.x, xs[5]) and torch.equal(s.before, xs[4])
    assert torch.equal(s.before2, xs[3]) and s.ihs == ihs[:4]
