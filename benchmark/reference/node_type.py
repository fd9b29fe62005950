"""Frozen copy of ``mmadmm_tpu_torch/geometry/node_type.py`` for the benchmark's reference.

Node classification (reference ``src/NodeType.h:4-8``).

Values match the reference enum so mask files written by either code are
interchangeable (``FromFile`` mode reads raw ints, ``MeshUtils.h:704-712``).
"""

import enum


class NodeType(enum.IntEnum):
    BOUNDARY_FREE = 0
    BOUNDARY_FIXED = 1
    INTERIOR = 2
