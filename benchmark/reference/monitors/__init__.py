"""The monitor of a configuration, found by its ``Dim`` and ``MonType``:
the module ``monitors/d<Dim>_type<MonType>.py`` with ``monitor(x [N, D])
-> M [N, D, D]``, a vectorized NumPy copy of the port's
``mmadmm_tpu_torch/monitors/__init__.py`` entry that the reference's
registry (``main.cpp:848-864``) puts at that index. A new monitor is a new
module here."""

from __future__ import annotations

import importlib

import numpy as np


def get_monitor(dim: int, mon_type: int):
    name = f"{__name__}.d{int(dim)}_type{int(mon_type)}"
    try:
        return importlib.import_module(name).monitor
    except ModuleNotFoundError as e:
        raise ValueError(f"the reference has no {dim}D monitor {mon_type}") from e


def eye_times(x: np.ndarray, s: np.ndarray) -> np.ndarray:
    """``s I`` at each point of ``x``."""
    D = x.shape[-1]
    out = np.zeros(x.shape[:-1] + (D, D), dtype=np.float64)
    idx = np.arange(D)
    out[..., idx, idx] = s[..., None]
    return out
