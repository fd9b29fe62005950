"""Energy and residual sums in float64 (port of
``mmadmm_tpu/ops/reductions.py``).

The JAX package sums f32 blocks of 512 in f32 and only the block sums in
f64, because f64 is emulated on the TPU. The card adds in f64 natively and
these sums are memory-bound, so a plain ``sum(dtype=float64)`` serves: it
is at least as accurate as the blocked sum, and differs from it by about
1e-7 relative for mesh-size f32 arrays.
"""

from __future__ import annotations

import torch


def sum_f64(x: torch.Tensor) -> torch.Tensor:
    """Sum of all elements, accumulated in float64 (``block_sum_f64``)."""
    return x.sum(dtype=torch.float64)


def sumsq_f64(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares; squares in the input dtype, sum in float64
    (``block_sumsq_f64``)."""
    return (x * x).sum(dtype=torch.float64)
