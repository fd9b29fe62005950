"""3D MonType 2: MEx23D, the radial cosine ring (``MEx3.h:11-19``)."""

from __future__ import annotations

import numpy as np

from . import eye_times


def monitor(x: np.ndarray) -> np.ndarray:
    """sqrt(0.01 / (2 + cos(8 pi r))) I, r = ||x - c||, c = 0.5."""
    PI = 3.141592653589793238462643383
    r = np.sqrt(np.sum((x - 0.5) ** 2, axis=-1))
    s = np.sqrt(0.01 / (2.0 + np.cos(8.0 * PI * r)))
    return eye_times(x, s)
