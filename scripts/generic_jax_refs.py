"""The JAX package's values on its default MM-ADMM route (float64, the
generic vmap prox with the carried chord Jacobian) that ``chip_smoke.py``
holds the port's card runs to.

    JAX_PLATFORMS=cpu python scripts/generic_jax_refs.py [NAME ...]

Prints, from the JAX package on the CPU (or only the runs whose labels
contain one of the NAMEs): ``Experiments/InputFiles/Monitor3320r.json`` as
loaded, steps 0 and 1 (``I_h`` and ADMM iterations); 3D CompSquare-20 in
float64, steps 0 and 1; the step-0 ``I_h`` (the energy of the initial
mesh) of 3D CompSquare-40 in float64; and the LevelSet circle at nx=320
(MonType 0, dt ``LEVELSET_DT``, tau 0.1, rho 50) over ``LEVELSET_STEPS``
steps (a few minutes a step on a CPU). Needs JAX.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mmadmm_tpu.config import ExperimentConfig, load_experiment_config  # noqa: E402
from mmadmm_tpu.problems import build_problem  # noqa: E402

# the circle at nx=320 diverges at the dt of tests/test_harness.py (1e-4,
# stable at nx=12): its energy jumps from 1.98 to 524 at step 1; at 1e-5 it
# rises at step 4; at 1e-6 it falls at every step
LEVELSET_DT = 1e-6
LEVELSET_STEPS = 4


def comp_square(n):
    return ExperimentConfig(test_type="SquareGrid", dim=3, mon_type=5, method=0, comp_mesh=True,
                            nx=n, ny=n, nz=n, dt=5e-3, tau=0.1, rho=10.0)


def steps(label, cfg, n):
    mesh, integ = build_problem(cfg)
    print(f"{label}: {type(integ).__name__}, prox {mesh.prox_backend}, j_carry {integ.j_carry}, "
          f"{mesh.n_elements} elements", flush=True)
    state = integ.init_state()
    for k in range(n):
        t = time.perf_counter()
        state, info = integ.step(state)
        print(f"  step {k}: I_h {float(info.ih_start)!r}, {int(info.n_iters)} ADMM iterations "
              f"({time.perf_counter() - t:.1f} s)", flush=True)


def step0(label, cfg):
    mesh, _ = build_problem(cfg)
    print(f"{label}: step-0 I_h {float(mesh.energy(mesh.X0))!r}", flush=True)


RUNS = {
    "Monitor3320r float64": lambda label: steps(label, load_experiment_config(
        os.path.join(ROOT, "Experiments", "InputFiles", "Monitor3320r.json")), 2),
    "3D CompSquare-20 float64": lambda label: steps(label, comp_square(20), 2),
    "3D CompSquare-40 float64": lambda label: step0(label, comp_square(40)),
    "LevelSet-320 float64": lambda label: steps(label, ExperimentConfig(
        test_type="LevelSet", dim=2, mon_type=0, method=0, nx=320, ny=320, dt=LEVELSET_DT,
        tau=0.1, rho=50.0), LEVELSET_STEPS),
}


def main() -> int:
    names = sys.argv[1:]
    for label, run in RUNS.items():
        if not names or any(n in label for n in names):
            run(label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
