"""The reference's steps of a traffic mix, found by the traffic's
``reference`` key: the module ``steps/<name>.py``, which gives

* ``build(cfg, mesh, *, dtype, device)``: the reference problem of the
  configuration on its mesh ``(X, F, mask)``;
* ``start(ref, x0)``: the state of a trajectory from the positions ``x0``;
* ``step(ref, state) -> (state, x, ih)``: one step, its positions and the
  I_h it reports;
* ``resume(ref, sample) -> (x or None, ih)``: the step that a window kept
  (``window.Sample``), worked out from what the window kept before it, as
  far as those hold the step's state (None where the positions cannot be).

A new method is a new module here."""

from __future__ import annotations

import importlib


def load(name: str):
    """The module ``steps/<name>.py``."""
    return importlib.import_module(f"{__name__}.{name}")
