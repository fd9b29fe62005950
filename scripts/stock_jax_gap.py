"""How far the port's stock engine and the JAX package's stock engine part,
on the CPU, beside how far the JAX package's own two prox routes part.

    JAX_PLATFORMS=cpu python scripts/stock_jax_gap.py [CASE ...]

Runs the cases of tests/test_torch_admm_stock.py (a 2D FromFile mesh at
Monitor3320r's dt, rho and AdmmIter over 12 steps; 3D CompSquare nx=4 over
4 steps) and 3D CompSquare nx=4 in float64 over 4 steps (the case of
tests/test_torch_f64_chord3d.py: the float64 K4'), each from the same
start state, and prints per step the ADMM iteration counts, the relative
gap in ``I_h`` and the largest gap in the node positions: the port on its
kernel route against the JAX kernel route (``prox_backend="pallas"``,
interpreted, in the case's dtype) and the JAX vmap route against the
kernel route. For the FromFile and the float64 cases it also prints the
largest gap of one prox call on the same inputs (the gathered start
positions and a seeded perturbation), port against JAX kernel. Last, the
JAX package's step-0
energy (``MovingMesh.energy`` at the start positions, float32) of 3D
CompSquare-20 and Monitor3320r, the values ``chip_smoke.py`` holds the
card's step-0 ``I_h`` to. ``CASE`` names (``fromfile2d``, ``comp3d``,
``comp3d_f64``) run only those cases. Needs JAX; runs on the CPU (the
interpreted float64 K4' compiles for some five minutes in some 15 GB).
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax.numpy as jnp  # noqa: E402
import test_torch_admm_stock as T  # noqa: E402
from mmadmm_tpu.config import ExperimentConfig as JaxConfig  # noqa: E402
from mmadmm_tpu.config import load_experiment_config as jax_load_config  # noqa: E402
from mmadmm_tpu.problems import build_problem as jax_build_problem  # noqa: E402

from mmadmm_tpu_torch import ExperimentConfig, build_problem, convert  # noqa: E402


# the cases of tests/test_torch_admm_stock.py, and CompSquare nx=4 in float64
CASES = {case: T.CASES[case][:2] for case in ("fromfile2d", "comp3d")}
CASES["comp3d_f64"] = (dict(T.CASES["comp3d"][0], dtype="float64"), 4)


def gaps(case: str, base: str) -> None:
    kw, steps = CASES[case]
    if kw["test_type"] == "FromFile":
        kw = dict(kw, base_dir=base)
    start, ref = T._jax_run(kw, steps, "pallas")
    _, other = T._jax_run(kw, steps, "vmap")
    _, integ = build_problem(ExperimentConfig(**kw, prox_backend="pallas"), device="cpu")
    state = convert.load_admm_state(integ, start)
    print(f"{case}: step, n_iters (port, JAX kernel, JAX vmap), I_h rel gap and max |x| gap "
          f"(port vs kernel; vmap vs kernel)", flush=True)
    for k in range(steps):
        state, info = integ.step(state)
        ih, it, x = ref[k][:3]
        print(f"  {k:2d}  {info.n_iters} {it} {other[k][1]}  "
              f"{abs(info.ih / ih - 1):.2e} {np.abs(state.x.numpy() - x).max():.2e}; "
              f"{abs(other[k][0] / ih - 1):.2e} {np.abs(other[k][2] - x).max():.2e}", flush=True)
    if kw["dim"] == 2 or kw["dtype"] == "float64":
        jmesh, jinteg = jax_build_problem(JaxConfig(**kw, prox_backend="pallas"))
        z = np.asarray(jmesh.gather(jmesh.X0))
        dxpu = (z + np.random.default_rng(0).normal(scale=1e-3, size=z.shape)).astype(z.dtype)
        zj, _ = jmesh.prox(jnp.asarray(z), jmesh.xi, jnp.asarray(dxpu), jmesh.elem_free,
                           integ.prox_tol, integ.prox_max_iters)
        zp, _ = integ.mesh.prox(torch.tensor(z), integ.mesh.xi, torch.tensor(dxpu), integ.free,
                                integ.prox_tol, integ.prox_max_iters)
        d = np.abs(np.asarray(zj) - zp.numpy()).reshape(len(z), -1).max(1)
        print(f"  one prox call on the start positions: max |z' gap| {d.max():.2e} "
              f"(element {int(d.argmax())}); {100 * float((d == 0).mean()):.2f} % of elements "
              f"bit-equal", flush=True)


def main() -> int:
    with tempfile.TemporaryDirectory() as base:
        T._write_fromfile(base)
        for case in [a for a in sys.argv[1:] if a in CASES] or CASES:
            gaps(case, base)
    cfg = JaxConfig(test_type="SquareGrid", dim=3, mon_type=5, method=0, comp_mesh=True,
                    nx=20, ny=20, nz=20, rho=10.0, dt=5e-3, tau=0.1, dtype="float32",
                    prox_backend="pallas")
    m3320r = jax_load_config(os.path.join(ROOT, "Experiments", "InputFiles",
                                          "Monitor3320r.json"), method=0)
    m3320r.dtype, m3320r.prox_backend = "float32", "pallas"
    for name, c in (("3D CompSquare-20", cfg), ("Monitor3320r", m3320r)):
        jmesh, _ = jax_build_problem(c)
        print(f"JAX step-0 energy, {name}: {float(jmesh.energy(jmesh.X0))!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
