"""The seeded displacement: the same for a seed, other for another, every
orientation kept, fixed nodes in place, the amplitude as the traffic says."""

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference.node_type import NodeType
from benchmark.tests._tiny import tiny_cell


@pytest.mark.parametrize("name", ["3DMonitor280.admm"])
def test_displacement(tmp_path, name):
    cell = tiny_cell(tmp_path, name)
    frac = cell.traffic["displacement"]
    big = 2**31 + 12345
    mesh, a = inputs.displaced(cell.cfg, frac, big, "cpu")
    _, b = inputs.displaced(cell.cfg, frac, big, "cpu")
    _, c = inputs.displaced(cell.cfg, frac, big + 1, "cpu")
    X, F, mask = mesh
    assert torch.equal(a, b) and not torch.equal(a, c)
    d = a.numpy() - X
    moved = mask == NodeType.INTERIOR
    assert np.all(d[~moved] == 0.0) and np.all(np.abs(d[moved]).max(1) > 0)
    assert np.abs(d).max() <= frac * inputs.spacing(cell.cfg)


def test_turned_element_is_refused(tmp_path):
    cell = tiny_cell(tmp_path, "3DMonitor280.admm")
    with pytest.raises(RuntimeError, match="turned"):
        inputs.displaced(cell.cfg, 3.0, 5, "cpu")
