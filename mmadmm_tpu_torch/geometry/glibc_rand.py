"""Bit-exact replication of glibc ``srand``/``rand`` (TYPE_3 additive
feedback generator).

The reference seeds ``srand(69)`` (``main.cpp:785``) and consumes ``rand()``
through ``Eigen::Vector::Random`` and a raw call for the Shoulder
experiment's random node perturbation (``main.cpp:614-626``). Reproducing
the stream exactly reproduces the reference's initial Shoulder meshes
bit-for-bit, which is what the recorded ``Ih*.txt`` baselines were measured
on.

Algorithm (glibc stdlib/random_r.c, TYPE_3: degree 31, separation 3):
  r[0] = seed; r[i] = 16807*r[i-1] mod 2^31-1 for i in 1..30 (computed in
  int32 via Schrage's trick, negative results wrapped); r[31..33] = r[0..2];
  then r[i] = r[i-31] + r[i-3] (mod 2^32) with the first 310 outputs
  discarded; each output is r[i] >> 1.

RAND_MAX = 2**31 - 1. ``eigen_random_double`` mirrors Eigen's
``random<double>()``: ``-1 + 2*rand()/RAND_MAX``.
"""

from __future__ import annotations

import numpy as np

RAND_MAX = 2**31 - 1


class GlibcRand:
    def __init__(self, seed: int = 1):
        self.srand(seed)

    def srand(self, seed: int) -> None:
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = [0] * 34
        r[0] = np.int32(seed)
        word = int(seed)
        for i in range(1, 31):
            # word = 16807*word % (2^31-1), Schrage with int32 wraparound
            hi = word // 127773
            lo = word % 127773
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        self._r = [v & 0xFFFFFFFF for v in (int(x) for x in r)]
        self._idx = 34  # next position to fill
        for _ in range(310):
            self._next_raw()

    def _next_raw(self) -> int:
        r = self._r
        v = (r[-31] + r[-3]) & 0xFFFFFFFF
        r.append(v)
        # keep the window bounded
        if len(r) > 4096:
            del r[:-34]
        return v >> 1

    def rand(self) -> int:
        return self._next_raw()

    def rand_array(self, n: int) -> np.ndarray:
        return np.array([self._next_raw() for _ in range(n)], dtype=np.int64)

    # --- Eigen interop -------------------------------------------------
    def eigen_random_double(self) -> float:
        """Eigen's ``random<double>()``: x in [-1, 1]."""
        return -1.0 + 2.0 * float(self.rand()) / float(RAND_MAX)

    def eigen_random_vector(self, d: int) -> np.ndarray:
        return np.array([self.eigen_random_double() for _ in range(d)])

    def uniform01(self) -> float:
        """``rand() / RAND_MAX`` as used in main.cpp:621."""
        return float(self.rand()) / float(RAND_MAX)
