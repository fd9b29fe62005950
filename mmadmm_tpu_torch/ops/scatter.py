"""Element <-> node gather and scatter: the ``Dmat`` operator
(port of ``mmadmm_tpu/ops/scatter.py``; reference
``Mesh::buildDMatrix``, ``src/Mesh.cpp:704-753``).

Every row of ``Dmat`` holds one 1.0, so ``D x`` is a gather ``x[F]`` and
``D^T y`` a scatter-add of element-slot values to nodes. The scatter uses
the degree-padded plan of ``geometry.topology.dense_scatter_plan``: one
gather and a sum over the padded incidence axis, deterministic in slot
order (``index_add_`` would add in a run-dependent order on the card).
"""

from __future__ import annotations

import torch


def gather_elements(x: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """D x: ``[NP, D] -> [NF, D+1, D]``."""
    return x[F.reshape(-1)].reshape(*F.shape, x.shape[-1])


def scatter_add_dense(vals: torch.Tensor, dense_idx: torch.Tensor) -> torch.Tensor:
    """D^T y: ``[NF, D+1, D] -> [NP, D]`` through the degree-padded plan
    ``dense_idx [NP, K]`` (padding points at an appended zero row)."""
    nf, dp1, d = vals.shape
    flat = vals.reshape(nf * dp1, d)
    padded = torch.cat([flat, flat.new_zeros((1, d))])
    np_, k = dense_idx.shape
    return padded[dense_idx.reshape(-1)].reshape(np_, k, d).sum(1)
