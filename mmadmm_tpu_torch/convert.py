"""Carry the JAX package's state into the port.

There are no weights here: the state is the mesh. These functions take the
JAX package's arrays, as NumPy, and load them into a port integrator built
from the same config, so that both packages start from the same bits
(each array is loaded in the integrator's own dtype: a float64 run's
state and constants stay float64 from end to end, never rounded through
float32):
``GridADMM2D`` constants and state, the Euler and backward-Euler state
(``EulerState`` / ``BackwardEulerState``, the backward-Euler chord carry
included), ``SoAADMM3D`` constants and
state, and the stock ``ADMMIntegrator``'s state. The tests use them;
nothing here imports JAX.

Array names follow the JAX package. 2D: the integrator's constants
``swap_k, alive_k [4, ny, nx]``, ``valid_t [T, 8, 128]``,
``free_t [6, T, 8, 128]``, the grid's ``cell_table`` and ``axes``, the
mesh's ``ehat``, and the state's ``x, x_prev [NP, 2]`` and
``u [6, T, 8, 128]`` (the tile layout is the port's ``[C, NFd]`` in the
same memory order). 3D (``SoAADMM3D``'s ``_consts``): ``swap_t, alive_t
[12, ncell]``, ``free_chunks [C, 12, S]``, ``valid [NFp]``, ``t_node
[NP]``, the grid's ``cell_table``, ``axes`` and ``sym6``, the mesh's
``ehat``, and the state's ``x, x_prev [3, NP]`` and ``u [C, 12, S]``.
The JAX engine pads the ``NFd`` dense slots to ``NFp = C S`` with clones
of the first slots, masked out by ``valid``; the port drops them. Stock
(``ADMMState``): ``x, x_prev [NP, D]``, ``u_bar [NF, D+1, D]``, the step
counters, and the generic prox's chord Jacobian ``J [NF, n, n]`` (``[NF,
0, 0]`` without the carry) and its ``j_fresh`` flag.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .integrators.admm import ADMMIntegrator, ADMMState
from .integrators.admm_grid2d import Grid2DState, GridADMM2D
from .integrators.admm_soa import SoA3DState, SoAADMM3D
from .integrators.backward_euler import BackwardEulerIntegrator, BackwardEulerState
from .ops.dense_eg2d import DenseEG2D


def _t(a, like: torch.Tensor, shape=None):
    t = torch.tensor(np.asarray(a), dtype=like.dtype, device=like.device)
    return t.reshape(shape if shape is not None else like.shape)


def _slots(a, nfd: int) -> np.ndarray:
    """The JAX engine's chunked ``[C, 12, S]`` as ``[12, NFd]``."""
    a = np.asarray(a)
    return a.transpose(1, 0, 2).reshape(12, -1)[:, :nfd]


def _load_grid(mesh, arrays: dict, dim: int) -> None:
    grid = mesh.grid
    if "cell_table" in arrays and grid.cell_table is not None:
        grid.cell_table = _t(arrays["cell_table"], grid.cell_table)
    if "sym6" in arrays and grid.sym6 is not None:
        grid.sym6 = _t(arrays["sym6"], grid.sym6)
    if "axes" in arrays:
        grid.axes = tuple(_t(a, ax) for a, ax in zip(arrays["axes"], grid.axes))
    if "ehat" in arrays:
        mesh.ehat_np = np.asarray(arrays["ehat"], dtype=np.float64).reshape(dim, dim)
        mesh.ehat = _t(mesh.ehat_np, mesh.ehat)


def load_grid2d_consts(integ: GridADMM2D, arrays: dict) -> None:
    """Replace the integrator's and its mesh's constants by ``arrays``
    (any subset of ``swap_k, alive_k, valid_t, free_t, cell_table, axes,
    ehat``)."""
    for key, attr in (("swap_k", "swap_k"), ("alive_k", "alive_k"),
                      ("valid_t", "valid"), ("free_t", "free")):
        if key in arrays:
            setattr(integ, attr, _t(arrays[key], getattr(integ, attr)))
    _load_grid(integ.mesh, arrays, 2)


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


def load_euler_state(integ, arrays: dict):
    """A port state for ``EulerIntegrator`` or ``BackwardEulerIntegrator``
    (an ``EulerState`` or a ``BackwardEulerState`` with no carried chord)
    from ``x`` and, optionally, ``x_prev`` (default ``x``: the JAX
    ``EulerState`` has none) and ``steps``."""
    like = integ.mesh.X0
    x = _t(arrays["x"], like)
    x_prev = _t(arrays["x_prev"], like) if "x_prev" in arrays else x
    return integ.init_state()._replace(x=x, x_prev=x_prev, steps=int(arrays.get("steps", 0)))


def load_be_state(integ: BackwardEulerIntegrator, arrays: dict) -> BackwardEulerState:
    """A port state for ``BackwardEulerIntegrator`` from the JAX
    ``BackwardEulerState``'s ``x, x_prev [NP, D], He [NF, n, n], dvec [NP,
    D], steps, rebuild``. A size-0 ``He`` or ``dvec`` (the JAX package's
    placeholders without the chord carry) loads as None. On the stencil
    engine ``He`` goes into its slots' lower triangle ``[21, NFd]``
    (``H[i][j]``, i >= j; carved slots 0)."""
    like = integ.mesh.X0
    He = np.asarray(arrays["He"])
    dvec = np.asarray(arrays["dvec"])
    He_t = dvec_t = None
    if He.size:
        eg = integ.eg
        if isinstance(eg, DenseEG2D):
            m = eg.mesh_of_dense
            rows = np.where(m[:, None, None] >= 0, He[np.maximum(m, 0)], 0.0)
            He = np.stack([rows[:, i, j] for i in range(6) for j in range(i + 1)])
        He_t = torch.tensor(He, dtype=like.dtype, device=like.device)
    if dvec.size:
        dvec_t = _t(dvec, like)
    return BackwardEulerState(
        x=_t(arrays["x"], like), x_prev=_t(arrays["x_prev"], like),
        steps=int(arrays["steps"]), He=He_t, dvec=dvec_t, rebuild=bool(arrays["rebuild"]))


def load_soa3d_consts(integ: SoAADMM3D, arrays: dict) -> None:
    """Replace the integrator's and its mesh's constants by ``arrays``
    (any subset of ``swap_t, alive_t, free_chunks, valid, t_node,
    cell_table, axes, sym6, ehat``). A constant grid keeps no cell table
    (the JAX package's bounds table equals the axes), a 48-wide one no
    ``sym6``."""
    for key in ("swap_t", "alive_t", "t_node"):
        if key in arrays:
            setattr(integ, key, _t(arrays[key], getattr(integ, key)))
    if "free_chunks" in arrays:
        integ.free = _t(_slots(arrays["free_chunks"], integ.NFd), integ.free)
    if "valid" in arrays:
        integ.valid = _t(np.asarray(arrays["valid"])[:integ.NFd], integ.valid)
    _load_grid(integ.mesh, arrays, 3)


def load_soa3d_state(integ: SoAADMM3D, arrays: dict) -> SoA3DState:
    """A port state from ``x, x_prev [3, NP], u [C, 12, S]`` and,
    optionally, the step counters ``steps, ih_last, rose, rises``."""
    like = integ.x0
    return SoA3DState(
        x=_t(arrays["x"], like),
        x_prev=_t(arrays["x_prev"], like),
        u=_t(_slots(arrays["u"], integ.NFd), like, (12, integ.NFd)),
        steps=int(arrays.get("steps", 0)),
        ih_last=float(arrays.get("ih_last", math.inf)),
        rose=bool(arrays.get("rose", False)),
        rises=int(arrays.get("rises", 0)),
    )


def load_admm_state(integ: ADMMIntegrator, arrays: dict) -> ADMMState:
    """A port state for the stock engine from the JAX ``ADMMState``'s
    ``x, x_prev [NP, D], u_bar [NF, D+1, D]`` and, optionally, ``steps,
    ih_last, rose, rises`` and ``J, j_fresh`` (default: the integrator's
    own fresh ``J``)."""
    like = integ.mesh.X0
    D = integ.mesh.dim
    own = integ.init_state()
    J = own.J
    if "J" in arrays:
        J = torch.tensor(np.asarray(arrays["J"]), dtype=like.dtype, device=like.device)
        if J.shape != own.J.shape:
            raise ValueError(f"J: expected shape {tuple(own.J.shape)}, got {tuple(J.shape)}")
    return ADMMState(
        x=_t(arrays["x"], like),
        x_prev=_t(arrays["x_prev"], like),
        u=_t(arrays["u_bar"], like, (integ.mesh.n_elements, D + 1, D)),
        steps=int(arrays.get("steps", 0)),
        ih_last=float(arrays.get("ih_last", math.inf)),
        rose=bool(arrays.get("rose", False)),
        rises=int(arrays.get("rises", 0)),
        J=J,
        j_fresh=bool(arrays.get("j_fresh", True)),
    )
