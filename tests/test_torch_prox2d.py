"""Kernel K1's plain PyTorch version (``mmadmm_tpu_torch/ops/prox2d.py``)
against the JAX package's component-form Pallas prox
(``mmadmm_tpu/ops/prox_pallas2d.py``, interpreter mode on the CPU). The
kernel itself is held to the plain version in tests/test_torch_kernels.py
and by chip_smoke.py, on the card.

Bands: the component energy and gradient within rtol 2e-5 (f32, as
tests/test_prox_pallas2d.py:53-92); a whole prox call as
tests/test_prox_pallas2d.py:95-119: ih0 within rtol 2e-5 and the
regularized energies after the solve within rtol 5e-5 (iterates of two
Newton solvers may differ where the energies agree)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.ops import prox_pallas2d as jp
from mmadmm_tpu.problems import build_problem as jax_build_problem

from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch.ops import prox2d as P

TOL, MAX_ITERS = 1e-5, 50


@pytest.fixture(scope="module", params=["SquareGrid", "Shoulder"])
def inputs(request):
    """Channel-major prox inputs ``[C, N]`` of a perturbed nx=8 mesh, one
    set for both packages (made with numpy)."""
    kw = dict(test_type=request.param, dim=2, mon_type=1, method=0, nx=8, ny=8,
              dt=5e-3, tau=0.1, rho=50.0, dtype="float32")
    jmesh, _ = jax_build_problem(JaxConfig(**kw))
    rng = np.random.default_rng(0)
    x = (np.asarray(jmesh.X0) + rng.normal(scale=2e-3, size=jmesh.X0.shape)).astype(np.float32)
    z = np.asarray(jmesh.gather(jnp.asarray(x)))  # [NF, 3, 2]
    dxpu = (z + rng.normal(scale=1e-3, size=z.shape)).astype(np.float32)
    nf = z.shape[0]
    from mmadmm_tpu.ops.monitor_grid import _cell_index

    ax, ay = jmesh.grid.axes
    xi = _cell_index(jnp.asarray(z[..., 0]), ax)
    yi = _cell_index(jnp.asarray(z[..., 1]), ay)
    rows = np.asarray(jmesh.grid.cell_table[(yi * (ax.shape[0] - 1) + xi).reshape(-1)])
    ch = dict(
        z=z.reshape(nf, 6).T.copy(), dxpu=dxpu.reshape(nf, 6).T.copy(),
        free=np.asarray(jmesh.elem_free).reshape(nf, 6).T.copy(),
        cells=rows.reshape(nf, 48).T.copy(),
    )
    ehat = tuple(float(v) for v in np.asarray(jmesh.ehat, dtype=np.float64).reshape(-1))
    return jmesh, ehat, ch


def _lists(ch):
    z = list(torch.tensor(ch["z"]))
    d = list(torch.tensor(ch["dxpu"]))
    f = list(torch.tensor(ch["free"]))
    c = torch.tensor(ch["cells"])
    return z, d, f, [[c[v * 16 + k] for k in range(16)] for v in range(3)]


def _jlists(ch):
    c = jnp.asarray(ch["cells"])
    return ([jnp.asarray(ch[k])[i] for i in range(6)] for k in ("z", "dxpu", "free")), \
        [[c[v * 16 + k] for k in range(16)] for v in range(3)]


def test_energy_c_matches_jax(inputs):
    jmesh, ehat, ch = inputs
    z, d, _, cells = _lists(ch)
    (jz, jd, _), jcells = _jlists(ch)
    ih, e = P.energy_c(z, cells, ehat, d, P._consts(jmesh.w)[1])
    jih, je = jp.energy_c(jz, jcells, ehat, jd, jmesh.w)
    np.testing.assert_allclose(ih.numpy(), np.asarray(jih), rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=2e-5, atol=1e-8)


def test_grad_c_matches_jax(inputs):
    jmesh, ehat, ch = inputs
    z, d, f, cells = _lists(ch)
    (jz, jd, jf), jcells = _jlists(ch)
    w2, half_w2, _ = P._consts(jmesh.w)
    g, ih, e = P.grad_c(z, cells, ehat, d, w2, half_w2, f)
    jg, jih, je = jp.grad_c(jz, jcells, ehat, jd, jmesh.w, jf)
    g, jg = np.stack([t.numpy() for t in g]), np.stack([np.asarray(t) for t in jg])
    np.testing.assert_allclose(g, jg, rtol=2e-5, atol=2e-5 * np.abs(jg).max())
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=2e-5, atol=1e-8)


def test_hessian_dual_matches_jvp(inputs):
    """The dual-number Hessian against JAX's jvp Hessian: same derivative
    rules, f32 rounding apart (band scaled by the largest entry)."""
    jmesh, ehat, ch = inputs
    z, d, f, cells = _lists(ch)
    (jz, jd, jf), jcells = _jlists(ch)
    w2, half_w2, _ = P._consts(jmesh.w)
    H = P.hess_c(z, cells, ehat, d, w2, half_w2, f)
    jH = jp.hess_c(jz, jcells, ehat, jd, jmesh.w, jf)
    got = np.stack([H[i][j].numpy() for i in range(6) for j in range(i + 1)])
    ref = np.stack([np.asarray(jH[i][j]) for i in range(6) for j in range(i + 1)])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def test_ldlt_matches_jax():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(6, 6, 64))
    S = np.einsum("ikn,jkn->ijn", A, A) + 6 * np.eye(6)[:, :, None]  # SPD per lane
    b = rng.normal(size=(6, 64))
    x = P.ldlt_c([[torch.tensor(S[i, j]) for j in range(6)] for i in range(6)],
                 [torch.tensor(b[i]) for i in range(6)])
    jx = jp.ldlt_c([[jnp.asarray(S[i, j]) for j in range(6)] for i in range(6)],
                   [jnp.asarray(b[i]) for i in range(6)])
    np.testing.assert_allclose(np.stack([t.numpy() for t in x]),
                               np.stack([np.asarray(t) for t in jx]), rtol=1e-12, atol=1e-12)
    ref = np.stack([np.linalg.solve(S[:, :, n], b[:, n]) for n in range(64)], axis=1)
    np.testing.assert_allclose(np.stack([t.numpy() for t in x]), ref, rtol=1e-10, atol=1e-10)


@pytest.fixture(scope="module")
def prox_pair(inputs):
    """One prox call of each package on the same inputs."""
    jmesh, ehat, ch = inputs
    nf = ch["z"].shape[1]
    kern = jp.make_prox_pallas2d(jmesh.ehat, jmesh.w, interpret=True)
    zj, ihj = kern(jmesh.grid, jnp.asarray(ch["z"].T.reshape(nf, 3, 2)), jmesh.xi,
                   jnp.asarray(ch["dxpu"].T.reshape(nf, 3, 2)),
                   jnp.asarray(ch["free"].T.reshape(nf, 3, 2)), TOL, MAX_ITERS)
    zj = np.asarray(zj).reshape(nf, 6).T
    t = {k: torch.tensor(v) for k, v in ch.items()}
    zp, ihp = P.prox2d(t["z"], t["dxpu"], t["free"], t["cells"], ehat, jmesh.w, TOL, MAX_ITERS)
    return jmesh, ehat, ch, (zj, np.asarray(ihj)), (zp.numpy(), ihp.numpy())


def test_prox_matches_pallas_interpret(prox_pair):
    jmesh, ehat, ch, (zj, ihj), (zp, ihp) = prox_pair
    np.testing.assert_allclose(ihp, ihj, rtol=2e-5, atol=1e-8)
    _, d, _, cells = _lists(ch)
    half_w2 = P._consts(jmesh.w)[1]
    e_j = P.energy_c(list(torch.tensor(zj)), cells, ehat, d, half_w2)[1].numpy()
    e_p = P.energy_c(list(torch.tensor(zp)), cells, ehat, d, half_w2)[1].numpy()
    np.testing.assert_allclose(e_p, e_j, rtol=5e-5, atol=1e-7)


def test_prox_moves_only_free_coordinates(prox_pair):
    _, _, ch, _, (zp, _) = prox_pair
    fixed = ch["free"] == 0
    np.testing.assert_array_equal(zp[fixed], ch["z"][fixed])
    assert np.all(np.isfinite(zp))


def test_plain_sweeps_only_active_elements(inputs):
    """The plain version sweeps only the elements still active, so an
    element's result must not depend on the others in the call: half of
    the elements alone give the same bits as inside the whole call."""
    jmesh, ehat, ch = inputs
    t = {k: torch.tensor(v) for k, v in ch.items()}
    stats = {}
    za, iha = P.prox2d_plain(t["z"], t["dxpu"], t["free"], t["cells"], ehat, jmesh.w,
                             TOL, MAX_ITERS, stats=stats)
    half = t["z"].shape[1] // 2
    zb, ihb = P.prox2d_plain(*(t[k][:, half:].contiguous() for k in ("z", "dxpu", "free", "cells")),
                             ehat, jmesh.w, TOL, MAX_ITERS)
    np.testing.assert_array_equal(zb.numpy(), za[:, half:].numpy())
    np.testing.assert_array_equal(ihb.numpy(), iha[half:].numpy())
    assert 1 <= stats["sweeps"] <= MAX_ITERS
    assert t["z"].shape[1] <= stats["element_sweeps"] <= stats["sweeps"] * t["z"].shape[1]


@pytest.mark.parametrize("bad", ["dtype", "shape", "stride", "cells"])
def test_wrapper_checks_inputs(inputs, bad):
    jmesh, ehat, ch = inputs
    t = {k: torch.tensor(v) for k, v in ch.items()}
    if bad == "dtype":
        t["z"] = t["z"].double()
    elif bad == "shape":
        t["dxpu"] = t["dxpu"][:5]
    elif bad == "stride":
        t["free"] = torch.tensor(ch["free"].T.copy()).T
    else:
        t["cells"] = t["cells"][:, :-1]
    with pytest.raises(ValueError):
        P.prox2d(t["z"], t["dxpu"], t["free"], t["cells"], ehat, jmesh.w, TOL, MAX_ITERS)


def test_cpu_tensors_take_the_plain_version(inputs):
    jmesh, ehat, ch = inputs
    t = {k: torch.tensor(v) for k, v in ch.items()}
    before = P.prox2d.launches
    za, iha = P.prox2d(t["z"], t["dxpu"], t["free"], t["cells"], ehat, jmesh.w, TOL, MAX_ITERS)
    zb, ihb = P.prox2d_plain(t["z"], t["dxpu"], t["free"], t["cells"], ehat, jmesh.w, TOL, MAX_ITERS)
    assert P.prox2d.launches == before
    assert torch.equal(za, zb) and torch.equal(iha, ihb)
