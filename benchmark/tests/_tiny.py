"""The cells of ``BENCHMARK.json`` at a size a CPU test holds: the same
files, with each configuration's ``nx = ny = nz`` set to ``N``."""

from __future__ import annotations

import json
import os

import torch

from benchmark import cells

N = 4
ROOT = cells.ROOT


def tiny_bench(tmp_path, n: int = N, **overrides) -> str:
    """A copy of ``BENCHMARK.json`` under ``tmp_path`` whose configuration
    files are the benchmark's own at ``n`` cells an axis (and
    ``overrides``); returns its path."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    os.makedirs(tmp_path / "configs", exist_ok=True)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg.update(nx=n, ny=n, nz=n, **overrides)
        c["file"] = os.path.join("configs", c["name"] + ".json")
        with open(tmp_path / c["file"], "w") as f:
            json.dump(cfg, f)
    path = str(tmp_path / "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path


def tiny_cell(tmp_path, name: str, **overrides):
    return cells.load(name, tiny_bench(tmp_path, **overrides))


def one_thread():
    """PyTorch on one thread (the test runner's workers share the cores)."""
    torch.set_num_threads(1)
