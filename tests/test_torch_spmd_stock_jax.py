"""The sharded stock MM-ADMM engine (ROADMAP A15) against the JAX
package's sharded runs on its 8 virtual CPU devices, on the routes the
dry run's 2D problem does not take: 3D SquareGrid nx=3 and a 2D
computational mesh (nx=6) with the carried chord Jacobian, both in
float64 on the generic prox, on 3 gloo ranks against 3 JAX devices.
Band, as tests/test_spmd.py's: ``I_h`` within rel 1e-12 and x within
1e-12 over 3 steps, equal ADMM counts.
"""

import numpy as np
import pytest

from _torch_spmd import jobs
from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch.parallel import launch
from test_torch_spmd import N_RANKS, SINGLE, _jax_run

CASES = {name: SINGLE[name] for name in ("3d", "comp2d")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch(jobs, N_RANKS, (CASES,), device="cpu", threads=1, timeout_s=600,
                  rendezvous_dir=str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_stock_runs_match_the_jax_package(ranks, name):
    method, steps, kw = CASES[name]
    (trace, x), (jtrace, jx) = ranks[0][name], _jax_run(method, steps, N_RANKS, **dict(kw))
    assert [n for _, n in trace] == [n for _, n in jtrace]
    np.testing.assert_allclose([i for i, _ in trace], [i for i, _ in jtrace], rtol=1e-12)
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-12)
