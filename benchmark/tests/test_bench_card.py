"""On the card: each cell at nx=8 through the kernels, held to the
reference; the K4 launches counted at the warm-up step. Skips where no
card is found (run it on the machine with the card:
``python3 -m pytest -q benchmark/tests/test_bench_card.py``)."""

import pytest
import torch

from benchmark import run
from benchmark.tests._tiny import tiny_cell


@pytest.mark.parametrize("name", ["3DMonitor280.admm", "3DMonitor280.euler"])
@pytest.mark.parametrize("traced", [False, True])
def test_cell_on_the_card(tmp_path, name, traced):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    result, compared = run.run_cell(tiny_cell(tmp_path, name, n=8), 2**31 + 21, 1.0, traced)
    assert result["correct"], compared
    assert result["device"]["platform"] == "gpu"
    if traced:
        assert result["device"]["busy_s"] > 0
