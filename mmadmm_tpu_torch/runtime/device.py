"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; there is
no silent fallback from CUDA to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises if CUDA is asked for (or implied)
    and PyTorch has no CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
