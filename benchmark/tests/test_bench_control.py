"""The control: the reference in float32, put in the program's place,
comes out as not correct against the limits, where the program in
float64 comes out correct, at nx=4 on the CPU for each traffic."""

import pytest

from benchmark import check, inputs, run
from benchmark.control import control_window
from benchmark.tests._tiny import one_thread, tiny_cell

CELLS = ["3DMonitor280.admm", "3DMonitor280.euler"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(tmp_path, name):
    one_thread()
    cell = tiny_cell(tmp_path, name)
    limits = cell.traffic["limits"]
    seed = 2**31 + 7
    mesh, x0 = inputs.displaced(cell.cfg, cell.traffic["displacement"], seed, "cpu")
    numbers = check.compare(cell, mesh, x0, control_window(cell, mesh, x0, seed))
    assert any(v > limits[k] for k, v in numbers.items()), numbers
    assert numbers["x_gap"] > 3 * limits["x_gap"]


@pytest.mark.parametrize("name", CELLS)
def test_program_passes(tmp_path, name):
    one_thread()
    result, compared = run.run_cell(tiny_cell(tmp_path, name), 2**31 + 7, 0.5, False,
                                    device="cpu")
    assert result["correct"], compared
