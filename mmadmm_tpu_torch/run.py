"""The experiment CLI (port of the JAX package's ``run.py``; the
reference's ``./mesh.exe <input> [method] [numThreads]``,
``main.cpp:784-799``).

Usage:
    python -m mmadmm_tpu_torch.run <inputName|path.json> [methodType] [nDevices] [options]

``inputName`` resolves against this repository's
``Experiments/InputFiles/`` when not a path (the reference CLI's
convention). ``methodType`` 0=MM-ADMM, 1=explicit Euler, 2=backward Euler
(clobbers the JSON ``Method`` key, like ``main.cpp:809``). ``nDevices``
above 1 needs multi-GPU runs, not yet ported (ROADMAP item A15). The run
goes to the card unless ``--device cpu``; artifacts go to ``--out``
(default ``Results/<name>``).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input", help="experiment name or path to JSON config")
    ap.add_argument("method", nargs="?", type=int, default=None,
                    help="0=ADMM, 1=Euler, 2=backward Euler")
    ap.add_argument("n_devices", nargs="?", type=int, default=1)
    ap.add_argument("--out", default=None, help="artifact output directory")
    ap.add_argument("--base-dir", default=None,
                    help="base dir for FromFile mesh paths (default: the root of the "
                         "tree holding the config's Experiments/ directory)")
    ap.add_argument("--dtype", default=None, choices=["float32", "float64"])
    ap.add_argument("--prox", default=None, choices=["vmap", "pallas"],
                    help="prox route: pallas = the CUDA prox kernels, vmap = the "
                         "generic prox")
    ap.add_argument("--steps", type=int, default=None, help="override nSteps")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", default=None, help="checkpoint file to resume")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="where the run goes (default: the card)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    from .config import load_experiment_config
    from .harness.experiments import INPUTS
    from .harness.runner import run_experiment

    if args.n_devices > 1:
        raise NotImplementedError("multi-GPU runs are ROADMAP item A15")
    path = args.input
    if not os.path.exists(path):
        cand = os.path.join(INPUTS, path + ".json")
        if os.path.exists(cand):
            path = cand
        else:
            print(f"config not found: {args.input}", file=sys.stderr)
            return 2
    cfg = load_experiment_config(path, method=args.method)
    cfg.n_devices = args.n_devices
    if args.dtype:
        cfg.dtype = args.dtype
    if args.prox:
        cfg.prox_backend = args.prox
    if args.steps is not None:
        cfg.n_steps = args.steps

    out_dir = args.out or os.path.join("Results", cfg.name)
    res = run_experiment(
        cfg,
        out_dir=out_dir,
        base_dir=args.base_dir,
        verbose=args.verbose,
        checkpoint_every=args.checkpoint_every,
        resume_from=args.resume,
        device=args.device,
    )
    s = res.summary()
    print(
        f"{cfg.name}: method={s['method']} steps={s['n_steps']} "
        f"converged={s['converged']} final_Ih={s['final_ih']:.6g}\n"
        f"setup={s['setup_time']:.2f}s compile={s['compile_time']:.2f}s "
        f"loop={s['loop_time']:.2f}s -> artifacts in {out_dir}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
