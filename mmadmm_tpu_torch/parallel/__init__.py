"""Multi-GPU runs: element-axis domain decomposition over ``torch.distributed``
(port of ``mmadmm_tpu/parallel``).

The element batch is split over the ranks in recursive-coordinate-bisection
order (``spmd.build_elem_shards``): the prox z-update and the dual update
run on each rank's own elements; node-field assembly (``D^T``) is a
partial sum on each rank and one all-reduce (``group.RankGroup``), over
the shared cut only in the owner-computes ADMM step.
"""

from .group import RankGroup, group_from_env, init_group, launch
from .spmd import ElemShards, MeshShard, build_elem_shards

__all__ = ["ElemShards", "MeshShard", "RankGroup", "build_elem_shards", "group_from_env",
           "init_group", "launch"]
