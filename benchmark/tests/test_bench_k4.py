"""The frozen K4 work count against the port's plain K4 at nx=4: the same
outputs bit for bit and the same operations on the step-0 prox inputs of
the 3D stencil configuration."""

import pytest
import torch

from benchmark.kernels import k4
from benchmark.reference import prox3d as frozen
from benchmark.tests._tiny import one_thread, tiny_cell


def step0_inputs(cell):
    """The first prox call of step 0 as the 3D stencil engine makes it."""
    from mmadmm_tpu_torch import build_problem, load_experiment_config

    cfg = load_experiment_config(cell.config_path, method=0)
    _, integ = build_problem(cfg, device="cpu")
    _, x, z, u = integ.start(integ.init_state())
    dxpu = integ.gather(x) + u
    args = (integ.mesh.ehat_np.reshape(-1), integ.w, integ.prox_tol, integ.prox_max_iters)
    return (z, dxpu.contiguous(), integ.free, integ.cells(z)), args


@pytest.mark.parametrize("name", ["3DMonitor280.admm"])
def test_frozen_k4_counts_the_ports_work(tmp_path, name):
    from mmadmm_tpu_torch.ops.prox3d import prox3d_plain

    one_thread()
    ins, args = step0_inputs(tiny_cell(tmp_path, name))
    zf, ihf = frozen.prox3d_plain(*ins, *args)
    zp, ihp = prox3d_plain(*ins, *args)
    assert torch.equal(zf, zp) and torch.equal(ihf, ihp)
    with k4.OpCounter() as c:
        prox3d_plain(*ins, *args)
    ops = k4.count_ops(*ins, *args)
    assert ops == c.ops and ops > 20_000 * ins[0].shape[1]


def test_bound():
    n = 1000
    # bytes bound: 265 values of 8 bytes a slot at 3.35 TB/s
    assert k4.bound_s(0, n, torch.float64) == pytest.approx(n * 265 * 8 / 3.35e12)
    assert k4.bound_s(1e9, n, torch.float64) == pytest.approx(1e9 / 33.5e12)
    assert k4.bound_s(1e9, n, torch.float32) == pytest.approx(1e9 / 67e12)
