"""The MM-ADMM step shared by the port's engines (reference
``MeshIntegrator::step``, ``MeshIntegrator.cpp:101-191``): an
energy-guarded predictor, then at most ``admm_iters`` iterations of prox
z-update (one kernel launch each), dual update and the diagonal x-update,
with the primal and dual residual stop. Control flow runs on the host: one
synchronisation per ADMM iteration reads both residuals.

The engines supply the operators: the 2D and 3D stencil engines
(``admm_grid2d.GridADMM2D``, ``admm_soa.SoAADMM3D``) on channel-major
slots, the stock engine (``admm.ADMMIntegrator``) on element-major
``[NF, D+1, D]`` blocks, and its sharded form
(``admm.ShardedADMMIntegrator``) on each rank's elements. The reduction
hook ``reduce`` is the identity on one device; over ranks it all-reduces
the f64 ``I_h`` sum and the stacked residual pair, so that every rank
reads the same bits and leaves the loop at the same iteration (a rank that
stopped alone would deadlock the rest), and ``finish`` rebuilds the
replicated x once a step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.reductions import sum_f64, sumsq_f64


class StepInfo(NamedTuple):
    ih: float  # energy at the first prox call of the step (f64 sum)
    primal: float
    dual: float
    n_iters: int  # ADMM iterations, one prox kernel launch each


class ADMMBase:
    """The MM-ADMM step on the engine's ``gather``, ``scatter``,
    ``x_update``, ``prox`` and ``euler_grad`` and its ``tau``, ``dt``,
    ``tol``, ``admm_iters``, ``grad_use`` and ``valid`` (1.0 on live
    element slots, shaped to broadcast against the engine's element
    values)."""

    def predict(self, state):
        """The energy-guarded predictor ``x_bar``: explicit Euler in the
        first three steps, after two rises in a row it holds x, after one
        rise Euler, else linear extrapolation (``admm.py:266-304``,
        ``admm_grid2d.py:250-269``, ``admm_soa.py:743-759``)."""
        x = state.x
        if self.grad_use or state.steps <= 2 or (state.rose and state.rises < 2):
            return x - (self.dt / self.tau) * self.euler_grad(x)
        if state.rose:
            return x
        return 2.0 * x - state.x_prev

    def reduce(self, t):
        """The sum of ``t`` over the ranks of a sharded engine."""
        return t

    def finish(self, x):
        """The replicated x at the end of a step."""
        return x

    def start(self, state):
        """Predictor and the first x-update: ``(x_bar, x, z, u)``."""
        x_bar = self.predict(state)
        z = self.gather(state.x if state.steps == 0 else x_bar)
        u = torch.zeros_like(state.u) if state.steps == 0 else state.u
        return x_bar, self.x_update(x_bar, z, u), z, u

    def step(self, state):
        """One MM-ADMM step: ``(state, StepInfo)``."""
        new_state, info, _ = self.admm(state)
        return new_state, info

    def admm(self, state, J_state=None):
        """One MM-ADMM step: ``(state, StepInfo, J_state)``. With
        ``J_state = (J, fresh)`` each prox call takes the chord Jacobian and
        hands its updated ``J`` to the next (``prox(z, dxpu, J_state) ->
        (z', ih0, J)``); the last one is returned."""
        x_bar, x, z, u = self.start(state)
        gx = self.gather(x)
        valid = self.valid
        ih_start = None
        primal = dual = 0.0
        n = 0
        for i in range(self.admm_iters):
            dxpu = gx + u
            z_prev = z
            if J_state is None:
                z, ih0 = self.prox(z, dxpu)
            else:
                z, ih0, J = self.prox(z, dxpu, J_state)
                J_state = (J, False)
            if i == 0:
                ih_start = self.reduce(sum_f64(torch.where(valid.reshape(-1) > 0, ih0, 0.0)))
            u = dxpu - z
            x = self.x_update(x_bar, z, u)
            gx = self.gather(x)
            res = self.reduce(torch.stack([sumsq_f64((gx - z) * valid),
                                           sumsq_f64((z - z_prev) * valid)]))
            primal, dual = torch.sqrt(res).tolist()
            n = i + 1
            if primal < self.tol and dual < self.tol:
                break
        x = self.finish(x)
        ih = float(ih_start) if ih_start is not None else 0.0
        rose = ih > state.ih_last
        new_state = state._replace(
            x=x, x_prev=state.x, u=u, steps=state.steps + 1, ih_last=ih,
            rose=rose, rises=state.rises + 1 if rose else 0,
        )
        return new_state, StepInfo(ih=ih, primal=primal, dual=dual, n_iters=n), J_state
