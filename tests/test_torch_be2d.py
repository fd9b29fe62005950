"""Kernels K2 and K3's plain PyTorch versions (``mmadmm_tpu_torch/ops/
be2d.py``) against the JAX package's ``make_be_kernels2d`` (Pallas in
interpreter mode on the CPU) at SquareGrid and Shoulder nx=16 (1024
slots, one tile). The kernels themselves are held to the plain versions
in tests/test_torch_kernels.py and by chip_smoke.py, on the card.

Inputs, the same for both packages: the slot positions of the step-0
mesh and of a seeded perturbation of it, and their cell rows.

Bands: ih within rtol 2e-5 (K1's ih0 band, tests/test_prox_pallas2d.py:
95-119); the gradient and the 21 Hessian channels within rtol 1e-4 and
atol 1e-6 times the largest |entry| of the same slot (XLA and PyTorch
order f32 operations differently, and a Hessian entry near zero carries
the rounding of the large ones)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.ops.prox_pallas2d import make_be_kernels2d
from mmadmm_tpu.problems import build_problem as jax_build_problem

from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem
from mmadmm_tpu_torch.mesh import MovingMesh
from mmadmm_tpu_torch.monitors import get_monitor
from mmadmm_tpu_torch.ops import be2d
from mmadmm_tpu_torch.ops.dense_eg2d import make_dense_eg2d
from mmadmm_tpu_torch.problems import build_geometry

KW = dict(dim=2, mon_type=1, method=1, nx=16, ny=16, dt=5e-3, tau=0.1, rho=50.0,
          dtype="float32")


@pytest.fixture(scope="module", params=[(t, p) for t in ("SquareGrid", "Shoulder")
                                        for p in ("step0", "perturbed")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def inputs(request):
    """``(ehat, z [6, 1024], cells [48, 1024], valid [1024])`` as numpy."""
    tt, which = request.param
    jmesh, _ = jax_build_problem(JaxConfig(test_type=tt, **KW))
    mesh, integ = build_problem(ExperimentConfig(test_type=tt, **KW), device="cpu")
    x = mesh.X0
    if which == "perturbed":
        rng = np.random.default_rng(3)
        x = x + torch.tensor(rng.normal(scale=2e-3, size=tuple(x.shape)), dtype=x.dtype)
    eg = integ.eg
    z = eg.gather(x).contiguous()
    ehat = np.asarray(jmesh.ehat, dtype=np.float64).reshape(-1)
    return ehat, z.numpy(), eg.cells(z).numpy(), eg.valid.numpy()


@pytest.fixture(scope="module")
def jax_out(inputs):
    ehat, z, cells, _ = inputs
    eg, hess = make_be_kernels2d(ehat, interpret=True)
    zt, ct = jnp.asarray(z.reshape(6, 1, 8, 128)), jnp.asarray(cells.reshape(48, 1, 8, 128))
    g, ih = eg(zt, ct)
    H = hess(zt, ct)
    return (np.asarray(g).reshape(6, -1), np.asarray(ih).reshape(-1),
            np.asarray(H).reshape(21, -1))


def _close_per_slot(got, ref, rtol, atol_frac):
    """|got - ref| <= rtol |ref| + atol_frac * max_c |ref[c, slot]|, the
    same non-finite entries in both."""
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    ok = np.isfinite(ref)
    scale = np.nanmax(np.where(ok, np.abs(ref), np.nan), axis=0, keepdims=True)
    bound = rtol * np.abs(ref) + atol_frac * np.broadcast_to(scale, ref.shape)
    bad = ok & ~(np.abs(got - ref) <= bound)
    assert not bad.any(), (
        f"{int(bad.sum())} entries out of band; worst "
        f"{np.max(np.abs(got - ref)[bad] / bound[bad]):.3g}x the bound")


def test_eg2d_plain_matches_jax(inputs, jax_out):
    ehat, z, cells, valid = inputs
    g, ih = be2d.eg2d_plain(torch.tensor(z), torch.tensor(cells), ehat)
    g_j, ih_j, _ = jax_out
    live = valid > 0
    np.testing.assert_allclose(ih.numpy()[live], ih_j[live], rtol=2e-5, atol=1e-8)
    _close_per_slot(g.numpy()[:, live], g_j[:, live], 1e-4, 1e-6)


def test_hess2d_plain_matches_jax(inputs, jax_out):
    ehat, z, cells, valid = inputs
    H = be2d.hess2d_plain(torch.tensor(z), torch.tensor(cells), ehat)
    assert tuple(H.shape) == (21, z.shape[1])
    live = valid > 0
    _close_per_slot(H.numpy()[:, live], jax_out[2][:, live], 1e-4, 1e-6)


def test_wrappers_take_the_plain_version_on_the_cpu(inputs):
    """On CPU tensors the wrappers return the plain versions' results and
    launch nothing."""
    ehat, z, cells, _ = inputs
    zt, ct = torch.tensor(z), torch.tensor(cells)
    before = (be2d.eg2d.launches, be2d.hess2d.launches)
    g, ih = be2d.eg2d(zt, ct, ehat)
    H = be2d.hess2d(zt, ct, ehat)
    g_p, ih_p = be2d.eg2d_plain(zt, ct, ehat)
    assert torch.equal(g, g_p) and torch.equal(ih, ih_p)
    assert torch.equal(H, be2d.hess2d_plain(zt, ct, ehat))
    assert (be2d.eg2d.launches, be2d.hess2d.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "device_mix", "noncontiguous"])
def test_wrappers_reject_bad_inputs(inputs, bad):
    ehat, z, cells, _ = inputs
    zt, ct = torch.tensor(z), torch.tensor(cells)
    if bad == "dtype":
        zt = zt.double()
    elif bad == "shape":
        ct = ct[:47]
    elif bad == "device_mix":
        ct = ct.to("meta")
    else:
        zt = torch.tensor(z.T.copy()).T
    for fn in (be2d.eg2d, be2d.hess2d):
        with pytest.raises(ValueError):
            fn(zt, ct, ehat)


@pytest.fixture(scope="module")
def f64_shoulder():
    """The Shoulder nx=16 slots in float64, for derivative checks."""
    cfg = ExperimentConfig(test_type="Shoulder", **KW)
    X, F, mask = build_geometry(cfg)
    mesh = MovingMesh(X, F, mask, get_monitor(2, 1), rho=50.0, tau=0.1,
                      dtype=torch.float64, device="cpu")
    eg = make_dense_eg2d(mesh, 16, 16)
    z = eg.gather(mesh.X0)
    live = eg.valid > 0
    return mesh.ehat_np.reshape(-1), z[:, live].contiguous(), eg.cells(z)[:, live].contiguous()


def test_hess2d_layout_and_levenberg_term(f64_shoulder):
    """Channel i*(i+1)/2 + j of ``hess2d_plain`` holds d g_i / d z_j, the
    forward derivative of ``eg2d_plain``'s gradient taken here by
    PyTorch's own forward-mode AD; the diagonal adds 1e-9 (float64: the
    band, 1e-13 of the slot's largest entry, is far below the term)."""
    ehat, z, cells = f64_shoulder
    H = be2d.hess2d_plain(z, cells, ehat)
    for j in range(6):
        with fwAD.dual_level():
            tangent = torch.zeros_like(z)
            tangent[j] = 1.0
            g, _ = be2d.eg2d_plain(fwAD.make_dual(z, tangent), cells, ehat)
            col = fwAD.unpack_dual(g).tangent  # [6, N]: d g_i / d z_j
        for i in range(j, 6):
            got = H[i * (i + 1) // 2 + j]
            want = col[i] + (1e-9 if i == j else 0.0)
            scale = col.abs().max(0).values
            assert torch.all((got - want).abs() <= 1e-13 * scale + 1e-15), (i, j)
