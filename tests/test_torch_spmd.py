"""Multi-GPU runs of the port (ROADMAP A15) on the CPU: ranks over gloo,
spawned once for the module (``parallel.launch``, a ``file://``
rendezvous in a temporary directory, a time limit on the join), held to
the JAX package's sharded runs on its 8 virtual CPU devices and to the
port's own one-device runs.

* ``ElemShards``: equal, field for field, to the JAX package's for 2D and
  3D meshes at 2, 3, 4 and 8 shards (NumPy only), and each rank's
  ``MovingMesh.shard`` equal to its rows of them.
* MM-ADMM at 2D SquareGrid nx=22 in float64 (the JAX dry run's problem:
  1,936 elements, so 3 ranks pad) on 3 ranks against the JAX package's
  3-device run: ``I_h`` within rel 1e-12, equal ADMM counts.
* Explicit and backward Euler on 3 ranks against the JAX 3-device runs,
  in the bands of ``tests/test_spmd_methods.py`` (``I_h`` rel 1e-9, x
  within 2e-7), equal Newton counts (and in
  tests/test_torch_spmd_stock_jax.py, MM-ADMM in 3D and on a 2D
  computational mesh).
* Sharded equal to single in the port, in the band of
  ``tests/test_spmd.py`` (rel 1e-12): 2D nx=4, 3D nx=3, uneven padding
  (nx=5, 100 elements on 3 ranks), a 2D computational mesh with the
  carried chord Jacobian, backward Euler with the ``hess`` solver (rel
  1e-9), and the kernel route's plain versions in float32 (K1 in 2D, K4
  and K4' in 3D; rel 1e-5, equal counts: float32 partial sums added in
  another order).
* The owner-computes halo equal to the full all-reduce (``I_h`` rel
  1e-13, equal counts, x rel 1e-12), and every rank's results equal bit
  for bit.
"""

import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.parallel.spmd import build_elem_shards as jax_build_elem_shards
from mmadmm_tpu.problems import build_problem as jax_build_problem

from _torch_spmd import BASE, config, jobs, run
from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import build_problem
from mmadmm_tpu_torch.parallel import launch
from mmadmm_tpu_torch.parallel.spmd import build_elem_shards

N_RANKS = 3
F32 = dict(dtype="float32", prox_backend="pallas")
# name: (method, steps, config and run keywords); one run on the ranks, one on one device
SINGLE = {
    "2d": (0, 3, dict(nx=4)),
    "3d": (0, 3, dict(dim=3, nx=3, stock=True)),
    "pad": (0, 3, dict(nx=5)),
    "comp2d": (0, 3, dict(nx=6, comp_mesh=True)),
    "be_hess": (2, 3, dict(nx=9, solver="hess")),
    "k1": (0, 3, dict(nx=8, **F32)),
    "k4": (0, 3, dict(dim=3, nx=3, stock=True, **F32)),
    "k4_chord": (0, 3, dict(dim=3, nx=3, comp_mesh=True, **F32)),
}
JAX = {
    "dryrun": (0, 3, dict(nx=22)),
    "euler": (1, 6, dict(nx=9)),
    "be": (2, 6, dict(nx=9)),
}
HALO = {
    "halo": (0, 4, dict(nx=6)),
    "full": (0, 4, dict(nx=6, halo=False)),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of every job, from one spawn of 3 ranks."""
    todo = {**SINGLE, **JAX, **HALO}
    return launch(jobs, N_RANKS, (todo,), device="cpu", threads=1, timeout_s=900,
                  rendezvous_dir=str(tmp_path_factory.mktemp("ranks")))


def test_every_rank_reads_the_same_bits(ranks):
    for r in ranks[1:]:
        for name, (trace, x) in r.items():
            assert trace == ranks[0][name][0], name
            np.testing.assert_array_equal(x, ranks[0][name][1], err_msg=name)


def _jax_run(method, steps, n_devices, **kw):
    from mmadmm_tpu.integrators.backward_euler import BackwardEulerIntegrator

    kw.pop("stock", None)  # the JAX package takes its stock engine over devices anyway
    c = config(method, n_devices, **kw)
    cfg = JaxConfig(**{f: getattr(c, f) for f in ("name", "test_type", "dim", "mon_type",
                                                  "method", "nx", "ny", "nz", "dt", "tau",
                                                  "rho", "dtype", "n_devices", "comp_mesh")})
    _, integ = jax_build_problem(cfg)
    assert integ.shards is not None
    s, trace = integ.init_state(), []
    for _ in range(steps):
        if method == 0:
            s, info = integ.step(s)
            trace.append((float(info.ih_start), int(info.n_iters)))
        elif isinstance(integ, BackwardEulerIntegrator):
            x, ih, n = integ._step_jit(s.x, *integ._args)  # the step keeps no Newton count
            s = s._replace(x=x, x_prev=s.x)
            trace.append((float(ih), int(n)))
        else:
            s, ih = integ.step(s)
            trace.append((float(ih), 0))
    return trace, np.asarray(s.x, dtype=np.float64)


@pytest.mark.parametrize("name", sorted(JAX))
def test_sharded_runs_match_the_jax_package(ranks, name):
    method, steps, kw = JAX[name]
    (trace, x), (jtrace, jx) = ranks[0][name], _jax_run(method, steps, N_RANKS, **dict(kw))
    assert [n for _, n in trace] == [n for _, n in jtrace]
    rtol, atol = (1e-12, 1e-12) if method == 0 else (1e-9, 2e-7)  # test_spmd_methods' bands
    np.testing.assert_allclose([i for i, _ in trace], [i for i, _ in jtrace], rtol=rtol)
    np.testing.assert_allclose(x, jx, rtol=0, atol=atol)


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_sharded_matches_single(ranks, name):
    method, steps, kw = SINGLE[name]
    (trace, x), (single, sx) = ranks[0][name], run(None, method, steps, **kw)
    assert [n for _, n in trace] == [n for _, n in single]
    rtol = 1e-5 if kw.get("dtype") == "float32" else 1e-9 if method == 2 else 1e-12
    np.testing.assert_allclose([i for i, _ in trace], [i for i, _ in single], rtol=rtol)
    np.testing.assert_allclose(x, sx, rtol=rtol * 10, atol=rtol)


def test_halo_matches_the_full_all_reduce(ranks):
    (th, xh), (tf, xf) = ranks[0]["halo"], ranks[0]["full"]
    assert [n for _, n in th] == [n for _, n in tf]
    np.testing.assert_allclose([i for i, _ in th], [i for i, _ in tf], rtol=1e-13)
    np.testing.assert_allclose(xh, xf, rtol=1e-12, atol=1e-15)


def _jax_mesh(dim, nx):
    from mmadmm_tpu.config import ExperimentConfig

    cfg = ExperimentConfig(**dict(BASE, method=0, dim=dim, nx=nx, ny=nx, nz=nx, comp_mesh=True))
    return jax_build_problem(cfg)[0]


@pytest.mark.parametrize("n_shards", [2, 3, 4, 8])
@pytest.mark.parametrize("dim,nx", [(2, 9), (3, 3)])
def test_elem_shards_equal_the_jax_package(dim, nx, n_shards):
    """Every field of ``ElemShards``, from the same host arrays (a
    computational mesh, so that xi is not zero), and through
    ``MovingMesh.build_shards``."""
    import jax.numpy as jnp

    m = _jax_mesh(dim, nx)
    args = (m._X_np, m._F_np, m._xi_np, m._elem_free_np, m.n_pnts, n_shards)
    ours, theirs = build_elem_shards(*args), jax_build_elem_shards(*args, jnp.float64)
    port_mesh, _ = build_problem(config(0, dim=dim, nx=nx, ny=nx, nz=nx, comp_mesh=True), "cpu")
    via_mesh = port_mesh.build_shards(n_shards)
    assert ours.dense_idx is not None
    for f in ours._fields:
        a, b = getattr(ours, f), np.asarray(getattr(theirs, f))
        assert a.dtype.kind == b.dtype.kind and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
        np.testing.assert_array_equal(getattr(via_mesh, f), a, err_msg=f)
    # each rank's own part (MovingMesh.shard) is its rows of the global arrays
    from mmadmm_tpu_torch.parallel import RankGroup

    L = ours.F.shape[0] // n_shards
    for r in range(n_shards):
        sh = port_mesh.shard(RankGroup(rank=r, size=n_shards, device=torch.device("cpu"),
                                       backend="gloo"))
        rows = slice(r * L, (r + 1) * L)
        for mine, glob in ((sh.F, ours.F[rows]), (sh.free, ours.elem_free[rows]),
                           (sh.xi, ours.xi[rows]), (sh.valid.reshape(-1), ours.valid[rows]),
                           (sh.perm, ours.perm[r]), (sh.seg, ours.seg[r]),
                           (sh.shared_ids, ours.shared_ids), (sh.contrib[:, 0], ours.contrib[r])):
            np.testing.assert_array_equal(mine.numpy(), glob)
        K = sh.dense_idx.shape[1]
        np.testing.assert_array_equal(sh.dense_idx.numpy(), ours.dense_idx[r][:, :K])
        assert (ours.dense_idx[r][:, K:] == L * (dim + 1)).all()


def test_sorted_plan_sums_as_the_degree_padded_plan():
    """Past its 512 MB gate a shard has no degree-padded plan and ``D^T``
    takes the sorted plan's segment sum (``spmd.py:151-167``): the same
    sums, in another order."""
    from mmadmm_tpu_torch.parallel import RankGroup

    mesh, _ = build_problem(config(0, nx=9), "cpu")
    vals = torch.as_tensor(np.random.default_rng(5).normal(size=(-(-mesh.n_elements // 3), 3, 2)))
    for r in range(3):
        shard = mesh.shard(RankGroup(rank=r, size=3, device=torch.device("cpu"), backend="gloo"))
        assert shard.dense_idx is not None
        dense = shard.partial(vals)
        shard.dense_idx = None
        np.testing.assert_allclose(shard.partial(vals).numpy(), dense.numpy(), rtol=1e-14,
                                   atol=1e-14)
