"""Small dense symmetric solves, one per element (port of
``mmadmm_tpu/ops/linalg.py``; the reference's per-element
``Eigen::...lu().solve`` inside its BFGS/Newton, ``src/Mesh.cpp:778-928``).

``ldlt_solve`` factors ``A = L D L^T`` without pivoting and without square
roots, over a batch ``[N, n, n]`` (n = 6 in 2D, 12 in 3D), in any dtype.
Every pivot with ``|d| < 1e-12`` becomes ``+1e-12`` (the JAX package's
code does this whatever the pivot's sign), so a near-singular system gives
a large but finite step that the caller's safeguards then judge.

Each entry sees the same operations in the same order as in the JAX
package's unrolled loops: ``A[i][j] - L[i][k] L[j][k] D[k]`` subtracted for
k = 0, 1, ... in turn, ``L[i][j] = s / d``, the forward solve's
subtractions for k = 0, 1, ..., the division by ``D``, and the back solve's
for k = i+1, i+2, .... The factorization and the forward solve are written
column by column (right-looking), which keeps that order per entry and
takes O(n) tensor operations instead of O(n^3); the back solve keeps the
JAX package's row order, whose subtractions need the unknowns in
ascending order. ``torch.linalg`` would pivot or reorder, and is not used.
"""

from __future__ import annotations

import torch

_DIAG_FLOOR = 1e-12


def ldlt_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` for a batch of small symmetric matrices:
    ``A [N, n, n]`` (only its lower triangle is read), ``b [N, n]``.
    Returns ``x [N, n]``."""
    n = A.shape[-1]
    W = A.clone()  # the trailing matrix, updated in place column by column
    D = torch.empty_like(b)
    for k in range(n):
        d = W[:, k, k]
        d = torch.where(torch.abs(d) < _DIAG_FLOOR, _DIAG_FLOOR, d)
        D[:, k] = d
        if k + 1 < n:
            L = W[:, k + 1:, k] / d[:, None]  # column k of L
            W[:, k + 1:, k] = L
            # A[i][j] -= L[i][k] L[j][k] D[k] for the rows and columns after k
            W[:, k + 1:, k + 1:] -= (L[:, :, None] * L[:, None, :]) * d[:, None, None]
    # forward solve L z = b
    z = b.clone()
    for k in range(n - 1):
        z[:, k + 1:] -= W[:, k + 1:, k] * z[:, k:k + 1]
    y = z / D
    # back solve L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[:, i]
        for k in range(i + 1, n):
            s = s - W[:, k, i] * x[k]
        x[i] = s
    return torch.stack(x, dim=1)
