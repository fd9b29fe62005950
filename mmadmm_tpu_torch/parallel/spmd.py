"""Element shards for multi-GPU runs (port of ``mmadmm_tpu/parallel/spmd.py``).

The shards are built on the host at set-up (NumPy), as in the JAX package:
the elements are put in recursive-coordinate-bisection order
(``geometry.topology.partition_elements``) so that contiguous shards are
spatially compact, padded to a multiple of the shard count with copies of
element 0 that carry ``valid = 0``, and each shard gets its own sorted and
degree-padded ``D^T`` plan and the halo plan of the owner-computes step.

``build_elem_shards`` returns the global arrays of every shard, field for
field those of the JAX ``ElemShards``. A rank builds only its own part:
``MeshShard`` (``MovingMesh.shard``) holds its rows and plans, and the
replicated halo plan, as tensors on its device, and is the one place that
decides how a rank gathers, scatters and masks its elements, for the
sharded MM-ADMM step and the sharded Euler and backward-Euler evaluator.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry.topology import dense_scatter_plan, partition_elements
from ..ops.scatter import gather_elements, scatter_add_dense

DENSE_PLAN_MAX_BYTES = 2**29  # the 512 MB gate of the stacked degree-padded plans


class ElemShards(NamedTuple):
    """Global padded element arrays in partition order (NumPy; float
    fields in float64). Shard ``s`` holds rows ``s*L:(s+1)*L``.

    The halo plan: the nodes touched by two or more shards form the shared
    cut set C (``shared_ids``); inside the ADMM loop only the ``[C, D]``
    partial sums are all-reduced, private nodes being complete on their
    one shard, and the replicated x is rebuilt once a step from the
    ownership mask ``contrib`` (one owner a node: the lowest shard that
    touches it)."""

    F: np.ndarray  # [NFp, D+1] int32
    xi: np.ndarray  # [NFp, D+1, D]
    elem_free: np.ndarray  # [NFp, D+1, D] 1.0 where movable
    valid: np.ndarray  # [NFp] 1.0 for real elements, 0.0 for padding
    perm: np.ndarray  # [S, L*(D+1)] int32
    seg: np.ndarray  # [S, L*(D+1)] int32
    dense_idx: Optional[np.ndarray]  # [S, NP, K] int32 degree-padded plans
    shared_ids: np.ndarray  # [C] int32
    is_shared: np.ndarray  # [NP] 1.0 on shared nodes
    shared_slot: np.ndarray  # [NP] int32 index into C, C for private nodes
    contrib: np.ndarray  # [S, NP] 1.0 where the shard owns the node

    @property
    def n_shards(self) -> int:
        return self.perm.shape[0]


def partition_order(X, F, n_shards: int):
    """``(order [NFp], valid [NFp], L)``: the element behind each row of
    the padded partition order (padding rows repeat the first), 1.0 on the
    real rows, and the rows a shard (``spmd.py:108-130``)."""
    nf = F.shape[0]
    order = partition_elements(X, F, n_shards) if n_shards > 1 else np.arange(nf)
    L = -(-nf // n_shards)
    pad = L * n_shards - nf
    valid = np.ones(L * n_shards, dtype=np.float64)
    valid[nf:] = 0.0
    return np.concatenate([order, np.repeat(order[:1], pad)]).astype(np.int64), valid, L


def _sorted_plan(rows):
    flat = rows.ravel()
    p = np.argsort(flat, kind="stable").astype(np.int32)
    return p, flat[p]


def _dense_gate(F_o, L: int, n_shards: int, n_pnts: int) -> bool:
    """Whether the stacked degree-padded plans stay under the 512 MB gate
    (K: the largest node degree within any shard)."""
    K = max(int(np.bincount(F_o[s * L:(s + 1) * L].ravel(), minlength=1).max())
            for s in range(n_shards))
    return n_shards * n_pnts * K * 4 < DENSE_PLAN_MAX_BYTES


def _halo_plan(F_o, L: int, n_shards: int, n_pnts: int):
    """``(shared_ids, is_shared, shared_slot, contrib [S, NP])``."""
    touch = np.zeros((n_shards, n_pnts), dtype=bool)
    for s in range(n_shards):
        # padding rows count: a shard holding copies of element 0 reads
        # its nodes too, so they must carry reduced values there
        touch[s, np.unique(F_o[s * L:(s + 1) * L])] = True
    count = touch.sum(axis=0)
    shared = count >= 2
    shared_ids = np.nonzero(shared)[0].astype(np.int32)
    n_c = shared_ids.shape[0]
    shared_slot = np.full(n_pnts, n_c, dtype=np.int32)
    shared_slot[shared_ids] = np.arange(n_c, dtype=np.int32)
    # shard 0 owns the untouched nodes, which keeps their zero-contribution
    # x-update rows
    owner = np.where(count > 0, np.argmax(touch, axis=0), 0)
    contrib = np.zeros((n_shards, n_pnts), dtype=np.float64)
    contrib[owner, np.arange(n_pnts)] = 1.0
    return shared_ids, shared.astype(np.float64), shared_slot, contrib


def build_elem_shards(X, F, xi, elem_free, n_pnts: int, n_shards: int) -> ElemShards:
    """Partition-order, pad and plan the element batch for ``n_shards``
    (``spmd.py:108-200``): every shard's plans."""
    order, valid, L = partition_order(X, F, n_shards)
    F_o = F[order]
    dp1 = F.shape[1]
    perms = np.empty((n_shards, L * dp1), dtype=np.int32)
    segs = np.empty((n_shards, L * dp1), dtype=np.int32)
    for s in range(n_shards):
        perms[s], segs[s] = _sorted_plan(F_o[s * L:(s + 1) * L])
    dense_idx = None
    if _dense_gate(F_o, L, n_shards, n_pnts):
        plans = [dense_scatter_plan(F_o[s * L:(s + 1) * L], n_pnts)[0] for s in range(n_shards)]
        K = max(p.shape[1] for p in plans)
        dense_idx = np.full((n_shards, n_pnts, K), L * dp1, dtype=np.int32)
        for s, p in enumerate(plans):
            dense_idx[s, :, :p.shape[1]] = p
    shared_ids, is_shared, shared_slot, contrib = _halo_plan(F_o, L, n_shards, n_pnts)
    return ElemShards(
        F=F_o.astype(np.int32), xi=np.asarray(xi[order], dtype=np.float64),
        elem_free=np.asarray(elem_free[order], dtype=np.float64), valid=valid, perm=perms,
        seg=segs, dense_idx=dense_idx, shared_ids=shared_ids, is_shared=is_shared,
        shared_slot=shared_slot, contrib=contrib,
    )


class MeshShard:
    """This rank's part of ``mesh``'s elements over ``group``, on the
    group's device: its rows of the padded partition order (``F``,
    ``free``, ``valid [L, 1, 1]``, and on a computational mesh ``xi``),
    the Ehat its elements divide by (``ehat``), its own ``D^T`` plan and
    the replicated halo plan (``shared_ids``, ``contrib``).

    * ``gather(x)``: ``D x`` on the rank's elements;
    * ``scatter(y, halo)``: ``D^T y`` of the rank's element values, padding
      masked, summed over the ranks: the whole ``[NP, D]`` field, or with
      ``halo`` only the shared cut (``admm.py:451-468``; the rows private to
      other ranks then stay incomplete here, and no element of this rank
      reads them);
    * ``owned(x)``: the replicated x rebuilt from each node's owner
      (``:587-592``);
    * ``all_rows(t)`` and ``own_rows(t)``: a per-element field (``u``,
      ``J``) from the ranks' rows to natural element order and back, so
      that a checkpoint resumes on any number of ranks.
    """

    def __init__(self, mesh, group):
        S, r = group.size, group.rank
        self.group, self.n_pnts, self.n_elements = group, mesh.n_pnts, mesh.n_elements
        order, valid, L = partition_order(mesh._X_np, mesh._F_np, S)
        F_o = mesh._F_np[order]
        rows = slice(r * L, (r + 1) * L)
        shared_ids, _, _, contrib = _halo_plan(F_o, L, S, mesh.n_pnts)

        def t(a, dt=mesh.dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=mesh.device)

        self.order = t(order, torch.int64)
        self.elems = self.order[rows]  # the element behind each of this rank's rows
        self.F = t(F_o[rows], torch.int64)
        self.free = t(mesh._elem_free_np[order[rows]])
        self.valid = t(valid[rows]).reshape(L, 1, 1)
        self.xi, self.ehat = None, mesh.ehat
        if mesh.comp_mesh:
            self.xi = t(mesh._xi_np[order[rows]])
            self.ehat = (self.xi[:, 1:] - self.xi[:, :1]).transpose(1, 2)
        self.shared_ids = t(shared_ids, torch.int64)
        self.contrib = t(contrib[r])[:, None]
        self.dense_idx = None
        if _dense_gate(F_o, L, S, mesh.n_pnts):
            self.dense_idx = t(dense_scatter_plan(F_o[rows], mesh.n_pnts)[0], torch.int64)
        perm, seg = _sorted_plan(F_o[rows])
        self.perm, self.seg = t(perm, torch.int64), t(seg, torch.int64)

    def gather(self, x):
        return gather_elements(x, self.F)

    def partial(self, y):
        """This rank's partial ``D^T y``, padding masked by ``valid``: the
        degree-padded sum, or past its gate the sorted plan's segment sum."""
        y = y * self.valid
        if self.dense_idx is not None:
            return scatter_add_dense(y, self.dense_idx)
        flat = y.reshape(-1, y.shape[-1])
        return flat.new_zeros((self.n_pnts, flat.shape[-1])).index_add_(0, self.seg,
                                                                         flat[self.perm])

    def scatter(self, y, halo: bool = False):
        part = self.partial(y)
        if not halo:
            return self.group.all_reduce_sum(part)
        ids = self.shared_ids
        return part.index_copy(0, ids, self.group.all_reduce_sum(part[ids]))

    def owned(self, x):
        return self.group.all_reduce_sum(x * self.contrib)

    def all_rows(self, t):
        """``[NF, ...]`` in natural element order from every rank's
        ``[L, ...]`` (a collective: every rank calls it)."""
        rows = self.group.all_gather(t)[:self.n_elements]
        return rows.new_empty(rows.shape).index_copy_(0, self.order[:self.n_elements], rows)

    def own_rows(self, t):
        """This rank's ``[L, ...]`` rows of a natural-order ``[NF, ...]``
        field (a padding row takes its copy's)."""
        return t[self.elems].contiguous()
