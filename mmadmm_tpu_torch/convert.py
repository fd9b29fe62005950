"""Carry the JAX package's state into the port.

There are no weights here: the state is the mesh. These functions take the
JAX package's arrays, as NumPy, and load them into a port integrator built
from the same config, so that both packages start from the same bits:
``GridADMM2D`` constants and state, and the Euler and backward-Euler
state (``EulerState`` / ``BackwardEulerState``). The tests use them;
nothing here imports JAX.

Array names follow the JAX package: the integrator's constants
``swap_k, alive_k [4, ny, nx]``, ``valid_t [T, 8, 128]``,
``free_t [6, T, 8, 128]``, the grid's ``cell_table`` and ``axes``, the
mesh's ``ehat``, and the state's ``x, x_prev [NP, 2]`` and
``u [6, T, 8, 128]`` (the tile layout is the port's ``[C, NFd]`` in the
same memory order).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .integrators.admm_grid2d import Grid2DState, GridADMM2D
from .integrators.euler import EulerState


def _t(a, like: torch.Tensor, shape=None):
    t = torch.tensor(np.asarray(a), dtype=like.dtype, device=like.device)
    return t.reshape(shape if shape is not None else like.shape)


def load_grid2d_consts(integ: GridADMM2D, arrays: dict) -> None:
    """Replace the integrator's and its mesh's constants by ``arrays``
    (any subset of ``swap_k, alive_k, valid_t, free_t, cell_table, axes,
    ehat``)."""
    grid = integ.mesh.grid
    for key, attr in (("swap_k", "swap_k"), ("alive_k", "alive_k"),
                      ("valid_t", "valid"), ("free_t", "free")):
        if key in arrays:
            setattr(integ, attr, _t(arrays[key], getattr(integ, attr)))
    if "cell_table" in arrays:
        grid.cell_table = _t(arrays["cell_table"], grid.cell_table)
    if "axes" in arrays:
        grid.axes = tuple(_t(a, ax) for a, ax in zip(arrays["axes"], grid.axes))
    if "ehat" in arrays:
        integ.mesh.ehat_np = np.asarray(arrays["ehat"], dtype=np.float64).reshape(2, 2)
        integ.mesh.ehat = _t(integ.mesh.ehat_np, integ.mesh.ehat)


def load_grid2d_state(integ: GridADMM2D, arrays: dict) -> Grid2DState:
    """A port state from ``x, x_prev, u`` and, optionally, the step
    counters ``steps, ih_last, rose, rises``."""
    like = integ.mesh.X0
    return Grid2DState(
        x=_t(arrays["x"], like),
        x_prev=_t(arrays["x_prev"], like),
        u=_t(arrays["u"], like, (6, integ.NFd)),
        steps=int(arrays.get("steps", 0)),
        ih_last=float(arrays.get("ih_last", math.inf)),
        rose=bool(arrays.get("rose", False)),
        rises=int(arrays.get("rises", 0)),
    )


def load_euler_state(integ, arrays: dict) -> EulerState:
    """A port state for ``EulerIntegrator`` or ``BackwardEulerIntegrator``
    from ``x`` and, optionally, ``x_prev`` (default ``x``: the JAX
    ``EulerState`` has none) and ``steps``."""
    like = integ.mesh.X0
    x = _t(arrays["x"], like)
    x_prev = _t(arrays["x_prev"], like) if "x_prev" in arrays else x
    return EulerState(x=x, x_prev=x_prev, steps=int(arrays.get("steps", 0)))
