"""How far the sweeps' work parts within a warp and a block, for the
Newton kernels K4 and K4''b and the chord kernels K4' and K4''a, on their
step-0 inputs.

    python3 scripts/sweep_divergence.py

Runs the plain versions on the card, 768,000 elements each: the Newton
sweeps (``ops/prox3d.py::prox3d_plain``, ``prox3d_comp_plain``) on the
step-0 prox inputs of 3D Shoulder-40 and 3D SquareGrid-40 (K4) and of 3D
CompSquare-40 with ``prox_chord=False`` (K4''b); the chord sweeps
(``prox3d_chord_comp_plain``, ``prox3d_chord_plain``) on the stock engine's
step-0 inputs of 3D CompSquare-40 (K4', rho 10: weakly regularized, its
elements stay active longer) and 3D SquareGrid-40 with ``prox_chord=True``
(K4''a, rho 50). It records for every element the sweeps it ran and, per
sweep, whether it built a Hessian (Newton) or refreshed its cached one
(chord), and prints:

- how many elements ran 1, 2, ... sweeps (and, for the chord sweeps, how
  many refreshed 0, 1, ... times);
- Newton: for one thread per element retiring after its step (a warp runs a
  full sweep while any of its 32 elements sweeps), the sum over warps of 32
  x the warp's most sweeps, over the element-sweeps; for one thread per
  element retiring before the Hessian, the sum over warps and sweeps of 32
  where any element of the warp builds a Hessian, over the Hessian builds;
  the second for the group design at 4 lanes per element (8 elements a
  warp);
- chord: for a warp of 32, 16, 8 and 4 elements (one thread, or 2, 4 and 8
  lanes per element), the warp's sweeps (the sum over warps of its size x
  its most sweeps, over the element-sweeps) and its refresh phases (the sum
  over warps and sweeps of its size where any element refreshes, over the
  refreshes). The sweeps of a warp of 32 are also those of the group
  design's block of 32 elements, which holds its SM until its last element
  is done.

A ratio of 1 means no element waits on another's sweep or refresh. Needs a
CUDA card (the plain versions at this size are for the card); run it from
the root of the repo.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as C  # noqa: E402
from mmadmm_tpu_torch.ops import newton as N  # noqa: E402
from mmadmm_tpu_torch.ops import prox3d as P3  # noqa: E402


def record(plain, inputs, args):
    """``(sweeps [n], builds [S, n])``: the sweeps each element ran, and in
    which sweep it built a Hessian (a Newton sweep) or refreshed its cached
    one (a chord sweep)."""
    n, dev = inputs[0].shape[1], inputs[0].device
    sweeps = torch.zeros(n, dtype=torch.int64, device=dev)
    builds, current = [], {}
    real_run, real_newton, real_chord = P3.run_sweeps, P3.newton_sweep, P3.chord_sweep

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

    def chord(not_first, zc, Hc, fns, edet_fn, inv_w2, tol, stats=None, grad=None):
        idx = torch.arange(n, device=dev)[current["sub"]]
        sweeps[idx] += 1
        refreshed = torch.zeros(n, dtype=torch.bool, device=dev)

        def fns_seen(rows):  # only a refresh asks for the Hessian
            grad_fn, hess_fn, energy_fn = fns(rows)

            def hess_seen(z):
                refreshed[idx[rows]] = True
                return hess_fn(z)
            return grad_fn, hess_seen, energy_fn

        out = real_chord(not_first, zc, Hc, fns_seen, edet_fn, inv_w2, tol, stats, grad)
        builds.append(refreshed)
        return out

    P3.run_sweeps, P3.newton_sweep, P3.chord_sweep = run, newton, chord
    try:
        plain(*inputs, *args)
    finally:
        P3.run_sweeps, P3.newton_sweep, P3.chord_sweep = real_run, real_newton, real_chord
    return sweeps, torch.stack(builds)


def per_warp(t, k):
    """``t [..., n]`` padded with zeros to a multiple of k, as ``[..., n/k, k]``."""
    pad = (-t.shape[-1]) % k
    t = torch.nn.functional.pad(t.to(torch.int64), (0, pad))
    return t.reshape(*t.shape[:-1], -1, k)


def chord_report(label, sweeps, refreshes):
    """The chord sweeps' counts and ratios (see the module's note)."""
    counts = torch.bincount(sweeps).tolist()
    per_element = torch.bincount(refreshes.sum(0)).tolist()
    n_sweeps, n_ref = int(sweeps.sum()), int(refreshes.sum())
    warp = {k: k * int(per_warp(sweeps, k).amax(-1).sum()) / n_sweeps for k in (32, 16, 8, 4)}
    phase = {k: k * int(per_warp(refreshes, k).amax(-1).sum()) / max(n_ref, 1)
             for k in (32, 16, 8, 4)}
    print(f"{label}: {sweeps.numel()} elements, {n_sweeps} element-sweeps, {n_ref} refreshes; "
          f"elements by sweeps run { {s: c for s, c in enumerate(counts) if c} }; elements by "
          f"refreshes { {r: c for r, c in enumerate(per_element) if c} }; sweeps of a warp of "
          f"32 / 16 / 8 / 4 elements: {' / '.join(f'{warp[k]:.4f}' for k in warp)}; refresh "
          f"phases of a warp of 32 / 16 / 8 / 4 elements: "
          f"{' / '.join(f'{phase[k]:.4f}' for k in phase)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_divergence: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}", flush=True)
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
    integ = C.comp_square(40)[2]
    cases.append(("K4', 3D CompSquare-40", P3.prox3d_chord_comp_plain, C.stock_inputs(integ),
                  (integ.w, integ.prox_tol, integ.prox_max_iters)))
    integ = C.square_chord(40)[2]
    cases.append(("K4''a, 3D SquareGrid-40", P3.prox3d_chord_plain, C.stock_inputs(integ),
                  (integ.mesh.ehat_np.reshape(-1), integ.w, integ.prox_tol,
                   integ.prox_max_iters)))
    for label, plain, inputs, args in cases:
        sweeps, builds = record(plain, inputs, args)
        if plain in (P3.prox3d_chord_comp_plain, P3.prox3d_chord_plain):
            chord_report(label, sweeps, builds)
            continue
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
