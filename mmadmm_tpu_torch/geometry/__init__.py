"""Host-side geometry (NumPy): mesh generation, carving, topology.

These modules are copies of ``mmadmm_tpu/geometry/`` kept in the port so
that it never imports the JAX package (whose ``__init__`` imports JAX).
Their outputs are bit-equal to the JAX package's
(``tests/test_torch_setup.py``).
"""

from .level_set import mesh_from_level_set
from .node_type import NodeType
from .rect_mesh import generate_uniform_rect_mesh
from .refine import refine_triangle_mesh
from .shoulder import make_shoulder_mesh
from .topology import (
    build_boundary_faces,
    dense_scatter_plan,
    node_degrees,
    reorient_elements,
)

__all__ = [
    "NodeType",
    "generate_uniform_rect_mesh",
    "mesh_from_level_set",
    "refine_triangle_mesh",
    "make_shoulder_mesh",
    "reorient_elements",
    "node_degrees",
    "dense_scatter_plan",
    "build_boundary_faces",
]
