"""A cell of ``BENCHMARK.json`` and the files it is found by: the
configuration ``configs/<config>.json``, the traffic ``traffic/<traffic>.json``
and a reader ``metrics/<metric>.py`` for each per-layer metric the cell
reports."""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    config: str
    chips: int
    cfg: dict  # the configuration file, reference-schema keys
    config_path: str
    traffic_name: str
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def load(name: str, bench_path: str | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (at the repository's root
    unless ``bench_path`` names another)."""
    bench_path = bench_path or os.path.join(ROOT, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path}; there are {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config_path = os.path.join(os.path.dirname(os.path.abspath(bench_path)), conf["file"])
    with open(config_path) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, config=w["config"], chips=int(w["chips"]), cfg=cfg,
                config_path=config_path, traffic_name=w["traffic"], traffic=traffic,
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str):
    """The module ``metrics/<metric>.py``."""
    return importlib.import_module(f"benchmark.metrics.{metric}")
