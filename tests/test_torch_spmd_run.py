"""Runs over ranks through the port's entry points (ROADMAP A15), on the
CPU with gloo:

* the CLI with nDevices 2 and ``--device cpu`` (``python -m
  mmadmm_tpu_torch.run <config> 0 2``): its ``I_h`` trace within rel
  1e-12 of the one-device CLI run, and a checkpoint that the 2-rank run
  writes (``u`` of both ranks in natural element order) resumed on 2
  ranks to the same final mesh, bit for bit;
* no silent fallback: a backend that cannot serve the ranks raises, a
  sharded config outside a rank group raises, and a rank that fails or
  hangs fails the run.
"""

import os

import numpy as np
import pytest

from _torch_spmd import fail_on_last, hang_on_last
from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem
from mmadmm_tpu_torch.harness import experiments as exps
from mmadmm_tpu_torch.parallel import launch
from mmadmm_tpu_torch.parallel.group import plan
from mmadmm_tpu_torch.run import main


def _trace(d):
    return np.loadtxt(os.path.join(d, "Ih0.txt"), delimiter=",", ndmin=2)[:, 1]


def test_cli_runs_on_two_ranks_and_resumes_bit_for_bit(tmp_path):
    cfg = str(tmp_path / "Tiny.json")
    exps.make_config_json(cfg, mon_type=1, n_steps=4, nx=5, dt_tol=1e-12, admm_iter=10)
    one, two, resumed = (str(tmp_path / d) for d in ("one", "two", "resumed"))
    assert main([cfg, "0", "1", "--device", "cpu", "--out", one]) == 0
    assert main([cfg, "0", "2", "--device", "cpu", "--out", two, "--checkpoint-every", "2"]) == 0
    np.testing.assert_allclose(_trace(two), _trace(one), rtol=1e-12)
    ckpt = os.path.join(two, "checkpoints", "step_000002.npz")
    with np.load(ckpt) as z:
        assert z["u_bar"].shape == (100, 3, 2)  # 5 x 5 x 4 elements, natural order
    assert main([cfg, "0", "2", "--device", "cpu", "--out", resumed, "--resume", ckpt]) == 0
    for f in ("points.txt", "triangles.txt", "mask.txt"):
        with open(os.path.join(two, f), "rb") as a, open(os.path.join(resumed, f), "rb") as b:
            assert a.read() == b.read(), f
    np.testing.assert_array_equal(_trace(resumed)[1:], _trace(two)[3:])


def test_no_silent_fallback():
    with pytest.raises(ValueError, match="gloo on the CPU"):
        plan(2, backend="nccl", device="cpu")
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch(fail_on_last, 2)
    with pytest.raises(RuntimeError, match="torchrun"):
        build_problem(ExperimentConfig(test_type="SquareGrid", mon_type=1, nx=4, ny=4,
                                       n_devices=2), "cpu")


@pytest.mark.parametrize("job,error", [(fail_on_last, Exception), (hang_on_last, TimeoutError)],
                         ids=["fails", "hangs"])
def test_a_rank_that_fails_or_hangs_fails_the_run(job, error, tmp_path):
    with pytest.raises(error):
        launch(job, 2, device="cpu", timeout_s=8, rendezvous_dir=str(tmp_path))
