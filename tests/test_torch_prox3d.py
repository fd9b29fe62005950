"""Kernel K4's plain PyTorch version (``mmadmm_tpu_torch/ops/prox3d.py``)
against the JAX package's component-form Pallas prox
(``mmadmm_tpu/ops/prox_pallas3d.py``, interpreter mode on the CPU). The
kernel itself is held to the plain version in tests/test_torch_kernels.py
and by chip_smoke.py, on the card.

Inputs: perturbed 3D meshes at nx=4, SquareGrid with the identity monitor
(a constant grid) and the radial bump (the 48-wide table), and Shoulder
with the identity (carve, fixed nodes), their cell channels fetched the
JAX engine's way, all in one batch with one Ehat (the JAX kernel takes
Ehat as a constant, and one interpreted kernel compiles for about two
minutes).

Bands: the component energy within rtol 2e-5 and gradient within rtol
3e-4, atol 3e-5 of its largest entry (tests/test_prox_pallas3d.py:64-87);
a whole prox call as tests/test_prox_pallas3d.py:88-108: ih0 within rtol
2e-5 and the regularized energies after the solve within rtol 1e-4, atol
1e-6 (iterates of two Newton solvers may differ where the energies
agree). The interpreted kernel compiles under the lock of
tests/_torch_soa3d.py, at most two such compiles at a time."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.mesh import MovingMesh as JaxMesh
from mmadmm_tpu.monitors import get_monitor as jax_monitor
from mmadmm_tpu.ops import prox_pallas2d as jp2
from mmadmm_tpu.ops import prox_pallas3d as jp
from mmadmm_tpu.ops.monitor_grid import _cell_index as jax_cell_index
from mmadmm_tpu.problems import build_geometry as jax_geometry

from _torch_soa3d import jax_compile_lock
from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch.ops import newton as N
from mmadmm_tpu_torch.ops import prox3d as P

TOL, MAX_ITERS = 1e-5, 50
SYM = [0, 1, 2, 4, 5, 8]


def _mesh_inputs(test_type, mon_type, rng):
    kw = dict(test_type=test_type, dim=3, mon_type=mon_type, method=0, nx=4, ny=4, nz=4,
              dt=5e-3, tau=0.1, rho=50.0, dtype="float32")
    X, F, mask, _ = jax_geometry(JaxConfig(**kw))
    jmesh = JaxMesh(X, F, mask, jax_monitor(3, mon_type), rho=50.0, tau=0.1, dtype=np.float32)
    x = (jmesh._X_np + rng.normal(scale=2e-3, size=jmesh._X_np.shape)).astype(np.float32)
    z = x[jmesh._F_np]  # [NF, 4, 3]
    dxpu = (z + rng.normal(scale=1e-3, size=z.shape)).astype(np.float32)
    grid = jmesh.grid
    ax, ay, az = grid.axes
    n = ax.shape[0] - 1
    parts = []
    for v in range(4):
        xi, yi, zi = (jax_cell_index(jnp.asarray(z[:, v, d]), a) for d, a in enumerate((ax, ay, az)))
        if grid.constant:
            sym = grid.values.reshape(-1, 9)[0][jnp.asarray(SYM)]
            vals = jnp.broadcast_to(jnp.tile(sym, 8)[:, None], (48, z.shape[0]))
        else:
            vals = grid.cell_table[(zi * n + yi) * n + xi].T
        parts += [vals, jnp.stack([ax[xi], ax[xi + 1], ay[yi], ay[yi + 1], az[zi], az[zi + 1]])]
    nf = z.shape[0]
    return jmesh, dict(
        z=z.reshape(nf, 12).T, dxpu=dxpu.reshape(nf, 12).T,
        free=np.asarray(jmesh.elem_free).reshape(nf, 12).T,
        cells=np.asarray(jnp.concatenate(parts)),
    )


@pytest.fixture(scope="module")
def inputs():
    """``(ehat, w, channel arrays [C, N])`` of the three meshes in one
    batch, with SquareGrid's Ehat."""
    rng = np.random.default_rng(0)
    meshes = [_mesh_inputs(tt, mon, rng) for tt, mon in
              (("SquareGrid", 0), ("SquareGrid", 1), ("Shoulder", 0))]
    jmesh = meshes[0][0]
    ch = {k: np.ascontiguousarray(np.concatenate([m[1][k] for m in meshes], axis=1))
          for k in ("z", "dxpu", "free", "cells")}
    ehat = tuple(float(v) for v in np.asarray(jmesh.ehat, dtype=np.float64).reshape(-1))
    return ehat, jmesh.w, ch


@pytest.fixture(scope="module")
def kernel_run(inputs):
    """One eager call of the interpreted JAX kernel, padded to whole tiles
    with clones of the first slots, as the JAX engine pads."""
    ehat, w, ch = inputs
    n = ch["z"].shape[1]
    T = -(-n // 1024)

    def tiles(a):
        a = np.concatenate([a, a[:, :T * 1024 - n]], axis=1)
        return jnp.asarray(a.reshape(a.shape[0], T, 8, 128))

    with jax_compile_lock():
        pf = jp.make_prox_pallas3d(np.asarray(ehat).reshape(3, 3), w, interpret=True)
        zo, ih0 = pf.tiled_call(tiles(ch["z"]), tiles(ch["dxpu"]), tiles(ch["free"]),
                                tiles(ch["cells"]), TOL, MAX_ITERS)
        return np.asarray(zo).reshape(12, -1)[:, :n], np.asarray(ih0).reshape(-1)[:n]


def _lists(ch):
    z, d, f = (list(torch.tensor(ch[k])) for k in ("z", "dxpu", "free"))
    return z, d, f, P._rows(torch.tensor(ch["cells"]))


def _jlists(ch):
    z, d, f = ([jnp.asarray(ch[k])[i] for i in range(12)] for k in ("z", "dxpu", "free"))
    c = jnp.asarray(ch["cells"])
    return z, d, f, [[c[v * 54 + k] for k in range(54)] for v in range(4)]


def test_energy_c3_matches_jax(inputs):
    ehat, w, ch = inputs
    z, d, _, cells = _lists(ch)
    jz, jd, _, jcells = _jlists(ch)
    ih, e = P.energy_c3(z, cells, ehat, d, N.consts(w)[1])
    jih, je = jp.energy_c3(jz, jcells, ehat, jd, w)
    np.testing.assert_allclose(ih.numpy(), np.asarray(jih), rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=2e-5, atol=1e-8)


def test_grad_c3_matches_jax(inputs):
    ehat, w, ch = inputs
    z, d, f, cells = _lists(ch)
    jz, jd, jf, jcells = _jlists(ch)
    w2, half_w2, _ = N.consts(w)
    g, ih, e = P.grad_c3(z, cells, ehat, d, w2, half_w2, f)
    jg, jih, je = jp.grad_c3(jz, jcells, ehat, jd, w, jf)
    g, jg = torch.stack(g).numpy(), np.stack([np.asarray(v) for v in jg])
    np.testing.assert_allclose(g, jg, rtol=3e-4, atol=3e-5 * np.abs(jg).max())
    np.testing.assert_allclose(ih.numpy(), np.asarray(jih), rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=2e-5, atol=1e-8)


def test_hess_c3_matches_jax(inputs):
    """The 78 lower entries of the dual-number Hessian against JAX's 12
    jvp passes, within rtol 3e-4 and atol 3e-5 of the largest entry (the
    gradient's band)."""
    ehat, w, ch = inputs
    z, d, f, cells = _lists(ch)
    jz, jd, jf, jcells = _jlists(ch)
    w2, half_w2, _ = N.consts(w)
    H = P.hess_c3(z, cells, ehat, d, w2, half_w2, f)
    jH = jp.hess_c3(jz, jcells, ehat, jd, w, jf)
    got = np.stack([H[i][j].numpy() for i in range(12) for j in range(i + 1)])
    ref = np.stack([np.asarray(jH[i][j]) for i in range(12) for j in range(i + 1)])
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-5 * np.abs(ref).max())


def test_ldlt_12_matches_jax():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(12, 12, 64)).astype(np.float32)
    S = (np.einsum("ikn,jkn->ijn", A, A) + 12 * np.eye(12)[:, :, None]).astype(np.float32)
    b = rng.normal(size=(12, 64)).astype(np.float32)
    x = N.ldlt_c([[torch.tensor(S[i, j]) for j in range(12)] for i in range(12)],
                 [torch.tensor(v) for v in b])
    jx = jp2.ldlt_c([[jnp.asarray(S[i, j]) for j in range(12)] for i in range(12)],
                    [jnp.asarray(v) for v in b])
    np.testing.assert_allclose(torch.stack(x).numpy(), np.stack([np.asarray(v) for v in jx]),
                               rtol=1e-5, atol=1e-6)


def test_prox3d_plain_matches_kernel(inputs, kernel_run):
    ehat, w, ch = inputs
    t = {k: torch.tensor(v) for k, v in ch.items()}
    zp, ihp = P.prox3d_plain(t["z"], t["dxpu"], t["free"], t["cells"], ehat, w, TOL, MAX_ITERS)
    zk, ihk = kernel_run
    np.testing.assert_allclose(ihp.numpy(), ihk, rtol=2e-5, atol=1e-7)
    rows = P._rows(t["cells"])
    half_w2 = N.consts(w)[1]
    e_p = P.energy_c3(list(zp), rows, ehat, list(t["dxpu"]), half_w2)[1].numpy()
    e_k = P.energy_c3(list(torch.tensor(zk)), rows, ehat, list(t["dxpu"]), half_w2)[1].numpy()
    np.testing.assert_allclose(e_p, e_k, rtol=1e-4, atol=1e-6)
    # fixed coordinates stay where they were
    fixed = ch["free"] == 0
    np.testing.assert_array_equal(zp.numpy()[fixed], ch["z"][fixed])


def test_prox3d_entry_runs_the_plain_version_on_the_cpu(inputs):
    """On CPU tensors the entry point is the plain version and launches no
    kernel."""
    ehat, w, ch = inputs
    t = {k: torch.tensor(v[:, :300].copy()) for k, v in ch.items()}
    before = P.prox3d.launches
    za, iha = P.prox3d(t["z"], t["dxpu"], t["free"], t["cells"], ehat, w, TOL, MAX_ITERS)
    zb, ihb = P.prox3d_plain(t["z"], t["dxpu"], t["free"], t["cells"], ehat, w, TOL, MAX_ITERS)
    assert P.prox3d.launches == before
    assert torch.equal(za, zb) and torch.equal(iha, ihb)


@pytest.mark.parametrize("bad", ["shape", "dtype", "cells_rows", "strided"])
def test_prox3d_rejects_bad_inputs(inputs, bad):
    ehat, w, ch = inputs
    t = {k: torch.tensor(v[:, :64].copy()) for k, v in ch.items()}
    if bad == "shape":
        t["dxpu"] = t["dxpu"][:, :32].contiguous()
    elif bad == "dtype":
        t["z"] = t["z"].double()
    elif bad == "cells_rows":
        t["cells"] = t["cells"][:200].contiguous()
    else:
        t["free"] = torch.tensor(ch["free"][:, :128].copy())[:, ::2]
    with pytest.raises(ValueError):
        P.prox3d(t["z"], t["dxpu"], t["free"], t["cells"], ehat, w, TOL, MAX_ITERS)
