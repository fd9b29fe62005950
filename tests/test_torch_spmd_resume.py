"""A checkpoint resumed on another number of ranks (ROADMAP A15), on the
CPU with gloo, through the port's CLI (``python -m mmadmm_tpu_torch.run
<config> 0 <n> --resume <file>``).

A checkpoint holds ``u`` (and ``J``) in natural element order whatever
the number of ranks that wrote it, so a run resumed on 2 ranks from a
one-device checkpoint, on one device from a 2-rank checkpoint, or on 3
ranks (which pad the 100 elements with copies of the first) continues
the run that wrote it: its step-4 checkpoint (x, the dual u and the
energy, in float64) to reduction order, within 1e-12. A dual read in
another element order parts from it at the first step (by about 5e-5).
"""

import os

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch.harness import experiments as exps
from mmadmm_tpu_torch.run import main


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(config path, {ranks: output dir})``: the CLI on one device and on
    2 ranks, each writing a checkpoint every 2 steps."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = str(tmp / "Tiny.json")
    exps.make_config_json(cfg, mon_type=1, n_steps=4, nx=5, dt_tol=1e-12, admm_iter=10)
    out = {k: str(tmp / f"ranks{k}") for k in (1, 2)}
    for k, d in out.items():
        assert main([cfg, "0", str(k), "--device", "cpu", "--out", d,
                     "--checkpoint-every", "2"]) == 0
    return cfg, out


@pytest.mark.parametrize("saved,ranks", [(1, 2), (2, 1), (1, 3)],
                         ids=["1to2", "2to1", "1to3_padded"])
def test_a_checkpoint_resumes_on_another_rank_count(runs, tmp_path, saved, ranks):
    cfg, out = runs
    ckpt = os.path.join(out[saved], "checkpoints", "step_000002.npz")
    resumed = str(tmp_path / "resumed")
    assert main([cfg, "0", str(ranks), "--device", "cpu", "--out", resumed, "--resume", ckpt,
                 "--checkpoint-every", "2"]) == 0
    last = os.path.join("checkpoints", "step_000004.npz")
    with np.load(os.path.join(resumed, last)) as a, np.load(os.path.join(out[saved], last)) as b:
        for k in ("x", "u_bar"):
            assert a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(a["ih_last"], b["ih_last"], rtol=1e-12)
