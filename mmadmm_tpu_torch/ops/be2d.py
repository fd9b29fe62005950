"""Per-element gradient, energy and Hessian for explicit and backward
Euler: kernels K2 and K3 and their plain PyTorch versions.

Port of ``mmadmm_tpu/ops/prox_pallas2d.py::make_be_kernels2d``:

* K2 (``eg_kernel``): the unregularized Huang gradient ``g [6, N]`` and
  energy ``ih [N]`` of every triangle,
* K3 (``hess_kernel``): the 6x6 Hessian of that gradient, its lower
  triangle as ``[21, N]`` with ``H[i][j]`` (i >= j) in channel
  ``i*(i+1)/2 + j`` and the 1e-9 Levenberg term on the diagonal.

Both are the prox's component math (``ops/prox2d.py::grad_c`` and
``hess_c``) with w = 0, dxpu = 0 and free = 1: the Euler integrators mask
at the node level, not per element. Inputs are the channel-major slot
positions ``z [6, N]`` and cell rows ``cells [48, N]``, both float32 or
both float64.

``eg2d`` and ``hess2d`` are the entry points. On a CPU tensor they run the
plain version; on a CUDA tensor they launch the kernel from
``csrc/be2d.cu`` built in the tensors' dtype (``mm_eg2d``/``mm_hess2d`` in
float32, ``mm_eg2d_f64``/``mm_hess2d_f64`` in float64) or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda_build import load_library
from .newton import count_launch
from .prox2d import ROW_W, _check, grad_c, hess_c

_ZERO6 = [0.0] * 6  # dxpu
_ONE6 = [1.0] * 6  # free


def _rows(cells):
    return [[cells[v * ROW_W + k] for k in range(ROW_W)] for v in range(3)]


def eg2d_plain(z, cells, ehat):
    """Plain K2: ``(g [6, N], ih [N])``."""
    g, ih, _ = grad_c(list(z), _rows(cells), tuple(float(v) for v in ehat),
                      _ZERO6, 0.0, 0.0, _ONE6)
    return torch.stack(g), ih


def hess2d_plain(z, cells, ehat):
    """Plain K3: the Hessian's lower triangle ``[21, N]``."""
    H = hess_c(list(z), _rows(cells), tuple(float(v) for v in ehat),
               _ZERO6, 0.0, 0.0, _ONE6)
    return torch.stack([H[i][j] for i in range(6) for j in range(i + 1)])


def _inputs(z, cells):
    n = z.shape[1]
    _check("z", z, 6, n, z.device, z.dtype)
    _check("cells", cells, 3 * ROW_W, n, z.device, z.dtype)
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the Euler kernels run on cpu or cuda, not {z.device}")
    return n


def eg2d(z, cells, ehat):
    """K2: ``(g [6, N], ih [N])`` for ``z [6, N]``, ``cells [48, N]``,
    float32 or float64. A CPU tensor goes to ``eg2d_plain``; a CUDA tensor
    launches the kernel built in its dtype on the current stream and counts
    it in ``eg2d.launches`` (float32) or ``eg2d.launches_f64`` (float64)."""
    n = _inputs(z, cells)
    if z.device.type == "cpu":
        return eg2d_plain(z, cells, ehat)
    g = torch.empty_like(z)
    ih = torch.empty(n, dtype=z.dtype, device=z.device)
    h = [float(v) for v in ehat]
    lib = library()
    rc = (lib.mm_eg2d_f64 if z.dtype == torch.float64 else lib.mm_eg2d)(
        z.data_ptr(), cells.data_ptr(), g.data_ptr(), ih.data_ptr(), n, *h,
        torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"eg2d kernel launch failed: CUDA error {rc}")
    count_launch(eg2d, z.dtype)
    return g, ih


def hess2d(z, cells, ehat):
    """K3: the Hessian's lower triangle ``[21, N]``. A CPU tensor goes to
    ``hess2d_plain``; a CUDA tensor launches the kernel built in its dtype
    on the current stream and counts it in ``hess2d.launches`` (float32)
    or ``hess2d.launches_f64`` (float64)."""
    n = _inputs(z, cells)
    if z.device.type == "cpu":
        return hess2d_plain(z, cells, ehat)
    H = torch.empty((21, n), dtype=z.dtype, device=z.device)
    h = [float(v) for v in ehat]
    lib = library()
    rc = (lib.mm_hess2d_f64 if z.dtype == torch.float64 else lib.mm_hess2d)(
        z.data_ptr(), cells.data_ptr(), H.data_ptr(), n, *h,
        torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hess2d kernel launch failed: CUDA error {rc}")
    count_launch(hess2d, z.dtype)
    return H


eg2d.launches = eg2d.launches_f64 = 0
hess2d.launches = hess2d.launches_f64 = 0

_P, _N, _F, _D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_double
_SIGNATURES = {
    # mm_hess2d_block(f64, shape): K3's block in float (0) or double
    "mm_hess2d_block": ([ctypes.c_int, ctypes.POINTER(ctypes.c_int)], None),
    # mm_eg2d(z, cells, g, ih, n, h00, h01, h10, h11, stream), Ehat in float;
    # mm_eg2d_f64 the same with double
    "mm_eg2d": ([_P] * 4 + [_N] + [_F] * 4 + [_P], ctypes.c_int),
    "mm_eg2d_f64": ([_P] * 4 + [_N] + [_D] * 4 + [_P], ctypes.c_int),
    # mm_hess2d(z, cells, h, n, h00, h01, h10, h11, stream), and mm_hess2d_f64
    "mm_hess2d": ([_P] * 3 + [_N] + [_F] * 4 + [_P], ctypes.c_int),
    "mm_hess2d_f64": ([_P] * 3 + [_N] + [_D] * 4 + [_P], ctypes.c_int),
}


def library() -> ctypes.CDLL:
    """K2's and K3's library, built from ``csrc/be2d.cu`` at first use."""
    return load_library("be2d", _SIGNATURES)


def hess_block(dtype) -> dict:
    """The block K3 launches with in ``dtype`` (float32 or float64), from
    the built library: ``elements`` and ``threads`` (one thread an
    element)."""
    shape = (ctypes.c_int * 2)()
    library().mm_hess2d_block(int(dtype == torch.float64), shape)
    return dict(zip(("elements", "threads"), shape))
