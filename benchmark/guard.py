"""The import guard: the port's benchmark runs without JAX and without
the JAX package ``mmadmm_tpu``. Module names are compared by their
top-level name (the part before the first dot) as a whole, so
``mmadmm_tpu_torch`` passes."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "mmadmm_tpu")


def forbidden(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules`` by
    default)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
