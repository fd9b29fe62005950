"""Shared set-up of the sharded-run tests: rank jobs that ``parallel.launch``
spawns (module-level functions, so that the spawned ranks can import them;
this module imports no JAX, so a rank starts in a couple of seconds).

``run(group, method, steps, **cfg)`` runs the port's integrator for
``steps`` steps, over ``group``'s ranks or, with ``group=None``, on one
device, and returns ``(trace, x)``: ``trace`` the ``(I_h, count)`` pairs
(ADMM iterations or Newton iterations; 0 for Euler), ``x`` the final
positions in float64. ``stock=True`` takes the stock engine on one device
where ``build_problem`` would take a stencil engine, so that sharded and
single runs share the prox route; ``solver`` names backward Euler's inner
solver.
"""

from __future__ import annotations

import numpy as np

from mmadmm_tpu_torch import ExperimentConfig, build_problem

BASE = dict(name="spmd", test_type="SquareGrid", dim=2, mon_type=1, dt=5e-3, tau=0.1,
            rho=50.0, dtype="float64")


def config(method, n_devices=1, **kw):
    c = dict(BASE, method=method, n_devices=n_devices)
    c.update(kw)
    c.setdefault("ny", c["nx"])
    c.setdefault("nz", c["nx"] if c["dim"] == 3 else 0)
    return ExperimentConfig(**c)


def run(group, method, steps, stock=False, halo=True, solver=None, **kw):
    cfg = config(method, **kw)
    mesh, integ = build_problem(cfg, "cpu", group=group, halo=halo)
    if solver is not None:
        from mmadmm_tpu_torch.integrators.backward_euler import BackwardEulerIntegrator

        integ = BackwardEulerIntegrator(mesh, cfg.dt, tol=cfg.step_tol, krylov_solver=solver,
                                        group=group)
    elif stock and group is None and method == 0:
        from mmadmm_tpu_torch.integrators.admm import ADMMIntegrator

        integ = ADMMIntegrator(mesh, cfg.dt, admm_iters=cfg.admm_iter, tol=cfg.step_tol,
                               prox_max_iters=cfg.prox_newton_iters)
    state = integ.init_state()
    trace = []
    for _ in range(steps):
        state, info = integ.step(state)
        trace.append((info.ih, getattr(info, "n_iters", getattr(info, "n_newton", 0))))
    return trace, state.x.numpy().astype(np.float64)


def jobs(group, todo):
    """Every job of ``todo`` (``{name: (method, steps, kw)}``) on this rank:
    ``{name: run(...)}``."""
    return {name: run(group, method, steps, **kw) for name, (method, steps, kw) in todo.items()}


def fail_on_last(group):
    """A rank job whose last rank raises."""
    if group.rank == group.size - 1:
        raise RuntimeError("rank failed on purpose")
    return group.rank


def hang_on_last(group):
    """A rank job whose last rank never returns."""
    import time

    if group.rank == group.size - 1:
        time.sleep(3600)
    return group.rank
