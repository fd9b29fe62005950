"""Interactive experiment menu: ``python -m mmadmm_tpu_torch.harness
[--device cpu|cuda]`` (port of ``mmadmm_tpu/harness/__main__.py``).

The reference's ``experiments.py`` is an interactive dispatcher: it prints
a function menu and ``eval``s the typed name in a loop
(``experiments.py:682-692``). Same workflow here, dispatching to the
library sweep functions instead of subprocess + mesh.exe. Bare config
names resolve against this repository's ``Experiments/InputFiles/``.
"""

from __future__ import annotations

import argparse
import os

from ..config import load_experiment_config
from . import experiments as exps
from .runner import run_experiment

FUNS = """
run_one()                  -- run a single config (any method)
run_method_comparison()    -- methods 0/1/2 on one config (Single*.json)
run_device_scaling()       -- device-count sweep (Para*.json analogue)
run_grid_scale()           -- grid-size sweep over <name><n>.json configs
run_simultaneous_experiment() -- matched size/device sweep (Simul*.json)
compare_to_reference()     -- parity report vs a recorded Ih<m>.txt trace
create_input()             -- write a reference-schema config JSON
exit()
"""


def _cfg_path(name: str) -> str:
    if os.path.exists(name):
        return name
    return os.path.join(exps.INPUTS, f"{name}.json")


def run_one(**run_kw):
    name = input("config name = ")
    method = int(input("method (0 1 2) = ") or "0")
    cfg = load_experiment_config(_cfg_path(name), method=method)
    res = run_experiment(cfg, out_dir=f"Results/{cfg.name}", verbose=True, **run_kw)
    print(f"final Ih={res.final_ih:.8g} steps={res.n_steps} "
          f"loop_time={res.loop_time:.2f}s")


def run_method_comparison(**run_kw):
    name = input("config name = ")
    out = exps.run_method_comparison(_cfg_path(name), out_dir=f"Results/{name}", **run_kw)
    for m, r in out["methods"].items():
        print(f"method {m}: {r['mean_time']:.2f}s final_ih={r['final_ih']:.8g}")


def run_device_scaling(**run_kw):
    name = input("config name = ")
    counts = input("device counts (default 1 2 4 8) = ") or "1 2 4 8"
    out = exps.run_device_scaling(
        _cfg_path(name), device_counts=[int(c) for c in counts.split()],
        out_dir=f"Results/{name}", **run_kw,
    )
    for nd, r in out["devices"].items():
        print(f"{nd} devices: {r['mean_time']:.2f}s "
              f"({r['steps_per_s']:.2f} steps/s)")


def run_grid_scale(**run_kw):
    name = input("test name (config prefix) = ")
    input_dir = input(f"input dir (default {exps.INPUTS}) = ") or exps.INPUTS
    exps.run_grid_scale(input_dir, name, out_dir=f"Results/{name}", **run_kw)


def run_simultaneous_experiment(**run_kw):
    name = input("test name (config prefix) = ")
    input_dir = input(f"input dir (default {exps.INPUTS}) = ") or exps.INPUTS
    out = exps.run_simultaneous_experiment(
        input_dir, name, out_dir=f"Results/{name}", **run_kw
    )
    for cfg, rec in out["configs"].items():
        for key, times in rec.items():
            print(f"{cfg} {key}: mean {sum(times)/len(times):.2f}s")


def compare_to_reference(**run_kw):
    name = input("config name = ")
    method = int(input("method (0 1 2) = ") or "0")
    cfg = load_experiment_config(_cfg_path(name), method=method)
    res = run_experiment(cfg, **run_kw)
    print(exps.compare_to_reference(res, name, method))


def create_input(**run_kw):
    out = input("output path = ")
    dim = int(input("Dim (2 3) = ") or "2")
    keys = ["test_type", "mon_type", "n_steps", "dt", "tau", "rho", "nx"]
    kw: dict = {"dim": dim}
    for k in keys:
        v = input(f"{k} = ")
        if v:
            kw[k] = type(exps.make_config_json.__kwdefaults__[k])(v)
    print("wrote", exps.make_config_json(out, **kw))


MENU = {
    "run_one()": run_one,
    "run_method_comparison()": run_method_comparison,
    "run_device_scaling()": run_device_scaling,
    "run_grid_scale()": run_grid_scale,
    "run_simultaneous_experiment()": run_simultaneous_experiment,
    "compare_to_reference()": compare_to_reference,
    "create_input()": create_input,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description="interactive experiment menu")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="where the runs go (default: the card)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="the ranks' backend (default: nccl on the card, gloo on the CPU)")
    args = ap.parse_args(argv)
    run_kw = dict(device=args.device, backend=args.backend)
    while True:
        print(FUNS)
        choice = input("experiments> ").strip()
        if choice in ("exit()", "exit", "quit", ""):
            return
        fn = MENU.get(choice if choice.endswith(")") else choice + "()")
        if fn is None:
            print(f"unknown function {choice!r}")
            continue
        try:
            fn(**run_kw)
        except KeyboardInterrupt:
            print("\n(interrupted)")
        except Exception as e:  # keep the REPL alive like the reference
            print(f"error: {type(e).__name__}: {e}")


if __name__ == "__main__":
    main()
