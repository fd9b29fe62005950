"""A run's result line: its keys, the numbers compared as its last key,
and no result without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.cells import ROOT
from benchmark.tests._tiny import one_thread, tiny_cell


@pytest.mark.parametrize("traced", [False, True])
def test_result_keys(tmp_path, traced):
    """A run on the CPU at nx=4 (the card's look skipped): the keys a
    result line must have, in a line that JSON carries, ``compared`` last."""
    one_thread()
    cell = tiny_cell(tmp_path, "3DMonitor280.euler")
    result, compared = run.run_cell(cell, 2**31 + 99, 0.3, traced, device="cpu")
    line = json.loads(json.dumps(result))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "compared" and line["correct"] is True
    assert set(line["compared"]) == set(compared) == {"x_gap", "ih_gap"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    else:
        assert set(line["metrics"]) == {"step_ms", "peak_gib", "setup_s"}
        assert all(m["value"] > 0 for k, m in line["metrics"].items() if k != "peak_gib")


def test_no_card_no_result():
    """Without a CUDA card the run exits 2 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "3DMonitor280.admm", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr
