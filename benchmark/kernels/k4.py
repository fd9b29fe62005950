"""The work of kernel K4 (the 3D prox, Newton sweeps, constant Ehat) on
the inputs it was given, counted on the benchmark's frozen plain copy
(``reference/prox3d.py``), never on the kernel's or the program's
counters, so that the count reads the same work whatever implements K4.

* Operations: the elements computed by float arithmetic, comparisons and
  selects in the plain version (one operation an output element; data
  movement is not counted), a frozen copy of ``chip_smoke.py``'s
  ``_OpCounter``. A fused multiply-add would be two; the kernels are built
  with ``--fmad=false`` and issue none.
* Bytes: the launch's inputs read once and its outputs written once, from
  their shapes: ``z``, ``dxpu``, ``free`` (12 rows each), ``cells`` (216),
  ``z'`` (12) and ``ih0`` (1), a value each slot.
* The bound of a launch is the larger of its operations over the float64
  peak outside the tensor cores and its bytes over the memory bandwidth.

Peaks: NVIDIA H100 SXM data sheet, dense: 33.5 TFLOP/s float64 outside the
tensor cores (the white paper's 64 float64 units an SM against 128 float32
ones; the data sheet rounds it to 34), 67 TFLOP/s float32, 3.35 TB/s of
HBM3. They assume the full 700 W; the run prints the card's power limit
beside the share.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..reference.prox3d import prox3d_plain

H100_BYTES_PER_S = 3.35e12
H100_F64_OPS_PER_S = 33.5e12
H100_F32_OPS_PER_S = 67e12
ROWS_MOVED = 12 + 12 + 12 + 216 + 12 + 1  # z, dxpu, free, cells in; z', ih0 out


class OpCounter(TorchDispatchMode):
    """Counts the elements computed by float arithmetic, comparisons and
    selects (one operation an output element); data movement is not
    counted."""

    OPS = {
        "add", "sub", "rsub", "mul", "div", "neg", "sqrt", "abs", "clamp_min",
        "clamp_max", "where", "gt", "ge", "lt", "le", "eq", "ne", "isfinite",
        "logical_and", "logical_not", "bitwise_and", "bitwise_not", "maximum",
        "reciprocal",
    }

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__.rstrip("_") in self.OPS:
            self.ops += out.numel()
        return out


def count_ops(z, dxpu, free, cells, ehat, w, tol, max_iters) -> int:
    """The operations the plain K4 does on these ``[C, N]`` inputs."""
    with OpCounter() as counter:
        prox3d_plain(z, dxpu, free, cells, ehat, w, tol, max_iters)
    return counter.ops


def bound_s(ops: float, n_slots: int, dtype) -> float:
    """The least time a launch over ``n_slots`` slots doing ``ops``
    operations could take on one H100."""
    f64 = dtype == torch.float64
    nbytes = (8 if f64 else 4) * ROWS_MOVED * n_slots
    peak = H100_F64_OPS_PER_S if f64 else H100_F32_OPS_PER_S
    return max(ops / peak, nbytes / H100_BYTES_PER_S)
