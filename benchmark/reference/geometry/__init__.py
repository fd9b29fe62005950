"""The mesh of a configuration, found by its ``TestType``: the module
``geometry/<TestType in lower case>.py`` with ``mesh(cfg) -> (X, F,
mask)``. A new test type is a new module here."""

from __future__ import annotations

import importlib


def geometry(cfg: dict):
    """``(X [NP, D] float64, F [NF, D+1] int32, mask [NP] int8)`` of the
    configuration ``cfg`` (reference-schema keys), F reoriented to positive
    volume (``Mesh.cpp:244-260``)."""
    kind = str(cfg["TestType"])
    try:
        mod = importlib.import_module(f"{__name__}.{kind.lower()}")
    except ModuleNotFoundError as e:
        raise ValueError(f"the reference has no geometry {kind!r}") from e
    X, F, mask = mod.mesh(cfg)
    F = F.copy()
    neg = signed_volumes(X, F) < 0
    F[neg, 1], F[neg, 2] = F[neg, 2].copy(), F[neg, 1].copy()
    return X, F, mask


def signed_volumes(X, F):
    """The signed area (2D) or ``det [x1-x0, x2-x0, x3-x0]`` (3D) of each
    element, NumPy or torch."""
    V = X[F]
    a, b = V[:, 1] - V[:, 0], V[:, 2] - V[:, 0]
    if X.shape[1] == 2:
        return a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
    c = V[:, 3] - V[:, 0]
    return (a[:, 0] * (b[:, 1] * c[:, 2] - b[:, 2] * c[:, 1])
            - a[:, 1] * (b[:, 0] * c[:, 2] - b[:, 2] * c[:, 0])
            + a[:, 2] * (b[:, 0] * c[:, 1] - b[:, 1] * c[:, 0]))
