"""Monitor functions M(x): R^D -> SPD(D).

The 11 example monitors from the reference (``Experiments/TestMonitors/*.h``,
registry at ``main.cpp:836-867``), implemented as vectorized NumPy callables
``monitor(x[N, D]) -> M[N, D, D]``. They are evaluated once per run at the
mesh vertices on the host (``MeshInterpolator::interpolateMonitor``,
``src/MeshInterpolator.cpp:244-259``); the hot path only samples the
resulting background grid, so these never need to run on device.

Finite-difference quirks of the reference are replicated bit-for-bit
(including the ``MEx53D`` bug where the y-derivative is overwritten by the
z-derivative, ``MEx53D.h:21-22``) because the recorded baselines were
produced with them.
"""

from __future__ import annotations

import numpy as np

_FD_H = 2.0 * np.sqrt(np.finfo(np.float64).eps)


def _eye_times(x: np.ndarray, s: np.ndarray) -> np.ndarray:
    D = x.shape[-1]
    out = np.zeros(x.shape[:-1] + (D, D), dtype=np.float64)
    idx = np.arange(D)
    out[..., idx, idx] = s[..., None]
    return out


def m_identity(x: np.ndarray) -> np.ndarray:
    """MEx0 (MEx0.h:10-14)."""
    return _eye_times(x, np.ones(x.shape[:-1]))


def m_radial_bump(x: np.ndarray) -> np.ndarray:
    """MEx1 (MEx1.h:11-18): (1 + mu1/(1 + mu2*||x-c||^2)) I, c = 0.5."""
    mu1 = mu2 = 20.0
    r2 = np.sum((x - 0.5) ** 2, axis=-1)
    return _eye_times(x, 1.0 + mu1 / (1.0 + mu2 * r2))


def m_aniso_layer(x: np.ndarray) -> np.ndarray:
    """MEx2 (MEx2.h:11-23): sech layer along x+y=1, anisotropic. 2D only."""
    s = x[..., 0] + x[..., 1] - 1.0
    lam1 = 1.0 + 1.0 / np.cosh(50.0 * s * s)
    lam2 = 1.0 / lam1
    isq = 1.0 / np.sqrt(2.0)
    v = np.array([isq, isq])
    vo = np.array([isq, -isq])
    M = lam1[..., None, None] * np.einsum("i,j->ij", v, v) + lam2[
        ..., None, None
    ] * np.einsum("i,j->ij", vo, vo)
    return M


def m_radial_ring(x: np.ndarray) -> np.ndarray:
    """MEx3 / MEx23D / MEx33D (MEx3.h:11-19): radial cosine ring."""
    PI = 3.141592653589793238462643383
    r = np.sqrt(np.sum((x - 0.5) ** 2, axis=-1))
    s = np.sqrt(0.01 / (2.0 + np.cos(8.0 * PI * r)))
    return _eye_times(x, s)


def m_sigmoid_front(x: np.ndarray) -> np.ndarray:
    """MEx4 (MEx4.h:10-23): arclength monitor of a sigmoid front along
    x+y=1, gradient via the reference's exact central differences."""
    h, eps = _FD_H, 0.01

    def u(a, b):
        return 1.0 / (1.0 + np.exp((a + b - 1.0) / (2.0 * eps)))

    gx = (u(x[..., 0] + h, x[..., 1]) - u(x[..., 0] - h, x[..., 1])) / (2.0 * h)
    gy = (u(x[..., 0], x[..., 1] + h) - u(x[..., 0], x[..., 1] - h)) / (2.0 * h)
    s = (1.0 + gx**2 + gy**2) ** 0.25
    return _eye_times(x, s)


def _spiral_u_2d(a, b):
    r = np.sqrt((a - 0.7) ** 2 + (b - 0.5) ** 2)
    theta = np.arctan((b - 0.5) / (a - 0.7))
    return 1.0 + 9.0 / (1.0 + 100.0 * r * r * np.cos(theta - 20.0 * r * r) ** 2)


def m_spiral_wave(x: np.ndarray) -> np.ndarray:
    """MEx5 (MEx5.h:10-26): spiral-wave arclength monitor, FD gradient."""
    h = _FD_H
    a, b = x[..., 0], x[..., 1]
    gx = (_spiral_u_2d(a + h, b) - _spiral_u_2d(a - h, b)) / (2.0 * h)
    gy = (_spiral_u_2d(a, b + h) - _spiral_u_2d(a, b - h)) / (2.0 * h)
    s = (1.0 + gx**2 + gy**2) ** 0.25
    return _eye_times(x, s)


def _spiral_u_3d(a, b, c):
    r = np.sqrt((a - 0.7) ** 2 + (b - 0.5) ** 2 + (c - 0.5) ** 2)
    theta = np.arctan((b - 0.5) / (a - 0.7))
    psi = np.arctan((c - 0.5) / (a - 0.7))
    return 1.0 + 9.0 / (1.0 + 100.0 * r * r * np.cos(theta + psi - 20.0 * r * r) ** 2)


def m_spiral_wave_3d(x: np.ndarray) -> np.ndarray:
    """MEx53D (MEx53D.h:10-31). Replicates the reference bug: the gradient
    is a 2-vector whose second entry (y-derivative) is overwritten by the
    z-derivative, so s = (1 + u_x^2 + u_z^2)^(1/4)."""
    h = _FD_H
    a, b, c = x[..., 0], x[..., 1], x[..., 2]
    gx = (_spiral_u_3d(a + h, b, c) - _spiral_u_3d(a - h, b, c)) / (2.0 * h)
    gz = (_spiral_u_3d(a, b, c + h) - _spiral_u_3d(a, b, c - h)) / (2.0 * h)
    s = (1.0 + gx**2 + gz**2) ** 0.25
    return _eye_times(x, s)


# Registries (main.cpp:848-864). Note the reference's 3D list pushes the
# identity monitor again at index 4 (main.cpp:862).
MONITORS_2D = [
    m_identity,
    m_radial_bump,
    m_aniso_layer,
    m_radial_ring,
    m_sigmoid_front,
    m_spiral_wave,
]
MONITORS_3D = [
    m_identity,
    m_radial_bump,
    m_radial_ring,
    m_radial_ring,
    m_identity,
    m_spiral_wave_3d,
]


def get_monitor(dim: int, mon_type: int):
    reg = MONITORS_2D if dim == 2 else MONITORS_3D
    return reg[mon_type]
