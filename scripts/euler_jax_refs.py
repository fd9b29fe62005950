"""The JAX package's explicit- and backward-Euler values that
``chip_smoke.py`` holds the port's card runs of the compact path to.

    JAX_PLATFORMS=cpu python scripts/euler_jax_refs.py

Prints, from the JAX package on the CPU, for
``Experiments/InputFiles/Monitor3320r.json`` as loaded (float64, 265,004
triangles; the compact path, since a FromFile mesh has no stencil engine)
with method 1 (explicit Euler) and method 2 (backward Euler, the default
``neumann`` solve): steps 0 and 1, their ``I_h`` and, for backward Euler,
their Newton iterations. About two minutes on a CPU. Needs JAX.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mmadmm_tpu.config import load_experiment_config  # noqa: E402
from mmadmm_tpu.problems import build_problem  # noqa: E402

M3320R = os.path.join(ROOT, "Experiments", "InputFiles", "Monitor3320r.json")


def main() -> int:
    for method in (1, 2):
        mesh, integ = build_problem(load_experiment_config(M3320R, method=method))
        print(f"Monitor3320r method {method}: {type(integ).__name__}, {mesh.dtype.__name__}, "
              f"{mesh.n_elements} elements, stencil engine {integ._grid2d is not None}",
              flush=True)
        state = integ.init_state()
        for k in range(2):
            t = time.perf_counter()
            if method == 1:
                state, ih = integ.step(state)
                extra = ""
            else:  # the jitted step also returns the Newton count
                ns, ih, n = integ._step_jit(tuple(state), *integ._args)
                state, extra = type(state)(*ns), f", {int(n)} Newton iterations"
            print(f"  step {k}: I_h {float(ih)!r}{extra} ({time.perf_counter() - t:.1f} s)",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
