"""Matrix-free Krylov solvers for the backward-Euler Newton systems (port
of ``mmadmm_tpu/ops/krylov.py``; reference ``accel_class``,
``lib/LASolver/accel_class.cpp:105-402``).

``bicgstab`` and ``cg`` keep the JAX package's shape: ``maxiter`` trips,
each one masked by ``done = ||r||^2 <= tol^2 ||b||^2`` (a converged solve
freezes, so further trips change nothing), the recurrence scalars as
float64 dots of the input-dtype products, and ``_safe_div``'s breakdown
freeze. A Python loop of ``maxiter`` trips with ``torch.where`` masks is the
counterpart of the JAX ``fori_loop``; nothing is read back to the host.
Both return ``(x, (iterations, ||r||^2))``, the count a 0-d int tensor.

``scipy_bicgstab`` is the algorithm and stop rule of
``jax.scipy.sparse.linalg.bicgstab`` (the JAX package's ``scipy`` inner
solver): stop when ``||r||^2 <= max(tol^2 ||b||^2, atol^2)``, after
``maxiter`` iterations or at a breakdown, with the dots and scalars in the
input dtype and the early exit on a small ``s``. Its stop test reads the
residual norm on the host once per iteration, as the JAX ``while_loop``
tests it on the device.
"""

from __future__ import annotations

import torch

from .reductions import sum_f64

_EPS = 1e-30  # breakdown floor for recurrence denominators (f64 scalars)


def _dot(a, b):
    """``<a, b>``: products in the input dtype, the sum in float64."""
    return sum_f64(a * b)


def _safe_div(num, den):
    """``num / den``, or 0 where ``|den|`` underflows (the trip that hits a
    breakdown freezes instead of making inf)."""
    bad = den.abs() < _EPS
    return torch.where(bad, 0.0, num / torch.where(bad, 1.0, den))


def _identity(v):
    return v


def bicgstab(matvec, b, *, tol: float = 1e-6, maxiter: int = 50, M=None):
    """BiCGStab (van der Vorst; ``scaler_cgstab::acc_scaler``,
    accel_class.cpp:280). ``matvec: x -> A x``, ``M: v -> M^-1 v``."""
    M = M or _identity
    f = b.dtype
    x = torch.zeros_like(b)
    r = rhat = b
    p = v = torch.zeros_like(b)
    tol2 = tol ** 2 * _dot(b, b)
    rho = alpha = omega = torch.ones((), dtype=torch.float64, device=b.device)
    rnorm2 = _dot(r, r)
    iters = torch.zeros((), dtype=torch.int32, device=b.device)
    for _ in range(int(maxiter)):
        done = rnorm2 <= tol2
        rho1 = _dot(rhat, r)
        beta = _safe_div(rho1 * alpha, rho * omega)
        p_new = r + beta.to(f) * (p - omega.to(f) * v)
        phat = M(p_new)
        v_new = matvec(phat)
        alpha1 = _safe_div(rho1, _dot(rhat, v_new))
        s = r - alpha1.to(f) * v_new
        shat = M(s)
        t = matvec(shat)
        omega1 = _safe_div(_dot(t, s), _dot(t, t))
        x_new = x + alpha1.to(f) * phat + omega1.to(f) * shat
        r_new = s - omega1.to(f) * t
        rnorm2_new = _dot(r_new, r_new)
        x, r, p, v = (torch.where(done, old, new)
                      for old, new in ((x, x_new), (r, r_new), (p, p_new), (v, v_new)))
        rho, alpha, omega, rnorm2 = (
            torch.where(done, old, new)
            for old, new in ((rho, rho1), (alpha, alpha1), (omega, omega1), (rnorm2, rnorm2_new)))
        iters = torch.where(done, iters, iters + 1)
    return x, (iters, rnorm2)


def cg(matvec, b, *, tol: float = 1e-6, maxiter: int = 50, M=None):
    """Preconditioned conjugate gradients (``scaler_conj::acc_scaler``,
    accel_class.cpp:402), for SPD systems."""
    M = M or _identity
    f = b.dtype
    x = torch.zeros_like(b)
    r = b
    p = M(r)
    tol2 = tol ** 2 * _dot(b, b)
    rz = _dot(r, p)
    rnorm2 = _dot(r, r)
    iters = torch.zeros((), dtype=torch.int32, device=b.device)
    for _ in range(int(maxiter)):
        done = rnorm2 <= tol2
        Ap = matvec(p)
        alpha = _safe_div(rz, _dot(p, Ap))
        x_new = x + alpha.to(f) * p
        r_new = r - alpha.to(f) * Ap
        z_new = M(r_new)
        rz_new = _dot(r_new, z_new)
        beta = _safe_div(rz_new, rz)
        p_new = z_new + beta.to(f) * p
        rnorm2_new = _dot(r_new, r_new)
        x, r, p = (torch.where(done, old, new) for old, new in ((x, x_new), (r, r_new), (p, p_new)))
        rz = torch.where(done, rz, rz_new)
        rnorm2 = torch.where(done, rnorm2, rnorm2_new)
        iters = torch.where(done, iters, iters + 1)
    return x, (iters, rnorm2)


def scipy_bicgstab(matvec, b, *, tol: float = 1e-5, atol: float = 0.0, maxiter: int,
                   M=None):
    """``jax.scipy.sparse.linalg.bicgstab(matvec, b, tol=tol, atol=atol,
    maxiter=maxiter, M=M)`` from ``x0 = 0``: returns ``x``."""
    M = M or _identity

    def vdot(a, c):
        return (a * c).sum()

    atol2 = torch.clamp_min(tol ** 2 * vdot(b, b), atol ** 2)
    x, r = torch.zeros_like(b), b  # r0 = b - A x0 with x0 = 0
    rhat, p, q = r, r, r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    alpha = omega = rho = one
    k = 0
    while float(vdot(r, r)) > float(atol2) and 0 <= k < maxiter:
        rho_ = vdot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p_ = r + beta * (p - omega * q)
        phat = M(p_)
        q_ = matvec(phat)
        alpha_ = rho_ / vdot(rhat, q_)
        s = r - alpha_ * q_
        exit_early = vdot(s, s) < atol2
        shat = M(s)
        t = matvec(shat)
        omega_ = vdot(t, s) / vdot(t, t)
        x = torch.where(exit_early, x + alpha_ * phat, x + (alpha_ * phat + omega_ * shat))
        r = torch.where(exit_early, s, s - omega_ * t)
        alpha, omega, rho, p, q = alpha_, omega_, rho_, p_, q_
        if float(rho_) == 0.0:
            k = -10
        elif float(omega_) == 0.0 or float(alpha_) == 0.0:
            k = -11
        else:
            k += 1
    return x
