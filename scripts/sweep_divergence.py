"""How far the Newton sweeps' work parts within a warp, for kernels K4 and
K4''b on their step-0 inputs.

    python3 scripts/sweep_divergence.py

Runs the plain versions (``ops/prox3d.py::prox3d_plain``,
``prox3d_comp_plain``) on the card on the step-0 prox inputs of 3D
Shoulder-40 and 3D SquareGrid-40 (K4) and of 3D CompSquare-40 with
``prox_chord=False`` (K4''b), 768,000 elements each, records for every
element the sweeps it ran and the sweeps in which it built a Hessian, and
prints:

- how many elements ran 1, 2, ... sweeps;
- for one thread per element retiring after its step (a warp runs a full
  sweep while any of its 32 elements sweeps): the sum over warps of 32 x
  the warp's most sweeps, over the element-sweeps;
- for one thread per element retiring before the Hessian: the sum over
  warps and sweeps of 32 where any element of the warp builds a Hessian,
  over the Hessian builds;
- the second for the group design at 4 lanes per element (8 elements a
  warp).

A ratio of 1 means no lane of a warp waits on another's sweep. Needs a CUDA
card (the plain versions at this size are for the card); run it from the
root of the repo.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as C  # noqa: E402
from mmadmm_tpu_torch.ops import newton as N  # noqa: E402
from mmadmm_tpu_torch.ops import prox3d as P3  # noqa: E402


def record(plain, inputs, args):
    """``(sweeps [n], builds [S, n])``: the sweeps each element ran, and in
    which sweep it built a Hessian."""
    n, dev = inputs[0].shape[1], inputs[0].device
    sweeps = torch.zeros(n, dtype=torch.int64, device=dev)
    builds, current = [], {}
    real_run, real_newton = P3.run_sweeps, P3.newton_sweep

    def run(z, max_iters, sweep, stats=None, carry=None):
        def sweep_seen(not_first, sub, zc, *rest):
            current["sub"] = sub
            return sweep(not_first, sub, zc, *rest)
        return real_run(z, max_iters, sweep_seen, stats, carry)

    def newton(not_first, zc, fns, edet_fn, inv_w2, tol, stats=None):
        idx = torch.arange(n, device=dev)[current["sub"]]
        sweeps[idx] += 1
        g = fns(slice(None))[0](zc)[0]
        go = ~(N._gnorm(g) < tol) if not_first else torch.ones_like(idx, dtype=torch.bool)
        built = torch.zeros(n, dtype=torch.bool, device=dev)
        built[idx[go]] = True
        builds.append(built)
        return real_newton(not_first, zc, fns, edet_fn, inv_w2, tol, stats)

    P3.run_sweeps, P3.newton_sweep = run, newton
    try:
        plain(*inputs, *args)
    finally:
        P3.run_sweeps, P3.newton_sweep = real_run, real_newton
    return sweeps, torch.stack(builds)


def per_warp(t, k):
    """``t [..., n]`` padded with zeros to a multiple of k, as ``[..., n/k, k]``."""
    pad = (-t.shape[-1]) % k
    t = torch.nn.functional.pad(t.to(torch.int64), (0, pad))
    return t.reshape(*t.shape[:-1], -1, k)


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_divergence: no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), flush=True)
    cases = []
    for label, tt, mon in (("K4, 3D Shoulder-40", "Shoulder", 0),
                           ("K4, 3D SquareGrid-40", "SquareGrid", 1)):
        integ = C.box3d(tt, mon, 40)[2]
        cases.append((label, P3.prox3d_plain, C.prox_inputs(integ),
                      (integ.mesh.ehat_np.reshape(-1), integ.w, integ.prox_tol,
                       integ.prox_max_iters)))
    integ = C.comp_square(40, prox_chord=False)[2]
    cases.append(("K4''b, 3D CompSquare-40", P3.prox3d_comp_plain, C.stock_inputs(integ),
                  (integ.w, integ.prox_tol, integ.prox_max_iters)))
    for label, plain, inputs, args in cases:
        sweeps, builds = record(plain, inputs, args)
        counts = torch.bincount(sweeps).tolist()
        late = 32 * int(per_warp(sweeps, 32).amax(-1).sum()) / int(sweeps.sum())
        n_built = int(builds.sum())
        early = {k: k * int(per_warp(builds, k).amax(-1).sum()) / n_built for k in (32, 8)}
        print(f"{label}: {sweeps.numel()} elements, {int(sweeps.sum())} element-sweeps, "
              f"{n_built} Hessian builds; elements by sweeps run "
              f"{ {s: c for s, c in enumerate(counts) if c} }; one thread per element, retire "
              f"after the step: {late:.4f}; one thread per element, retire before the Hessian: "
              f"{early[32]:.4f}; 4 lanes per element: {early[8]:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
