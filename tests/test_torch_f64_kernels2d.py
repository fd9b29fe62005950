"""Kernels K1, K2 and K3 in float64: their plain PyTorch versions
(``mmadmm_tpu_torch/ops/prox2d.py``, ``ops/be2d.py``) against the JAX
package's Pallas kernels built in float64 (``make_prox_pallas2d`` and
``make_be_kernels2d``, interpreter mode on the CPU), on the same inputs:
the float64 stencil engine's slots at Shoulder nx=16 (1024 slots, one
tile). The float64 kernels themselves are held to the plain versions bit
for bit in tests/test_torch_kernels.py and by chip_smoke.py, on the card.

Inputs, made with numpy from a seed: K1's step-0 prox inputs of the port's
float64 ``GridADMM2D`` with the dual perturbed; K2's and K3's slot
positions of the initial mesh perturbed.

Bands, float64 (both sides run the same operations; XLA and PyTorch order
a few of them differently, and PyTorch's CPU square root is not always
correctly rounded): K1's ih0 within rtol 1e-12, the regularized energies
after the solve within rtol 1e-10 and the iterates within atol 1e-10
(measured on an Intel Xeon CPU: 1.0e-15, 6.7e-16 and 1.1e-16); K2's ih
within rtol 1e-12, its gradient and K3's 21 channels within rtol 1e-10
and atol 1e-12 of the slot's largest entry (measured: 1.2e-15, 1.5e-15
and 1.7e-15 of the slot's largest entry)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmadmm_tpu.ops import prox_pallas2d as jp

from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem
from mmadmm_tpu_torch.integrators.admm_grid2d import GridADMM2D
from mmadmm_tpu_torch.ops import be2d as B
from mmadmm_tpu_torch.ops import prox2d as P

KW = dict(test_type="Shoulder", dim=2, mon_type=1, method=0, nx=16, ny=16, dt=5e-3, tau=0.1,
          rho=50.0, dtype="float64")


def _tiles(t):
    """``[C, 1024]`` as the JAX kernels' one tile ``[C, 1, 8, 128]``."""
    return jnp.asarray(t.numpy().reshape(t.shape[0], 1, 8, 128))


@pytest.fixture(scope="module")
def k1_case():
    """``(integrator, channel inputs, args, JAX (z', ih0), plain (z', ih0))``."""
    _, integ = build_problem(ExperimentConfig(**KW), device="cpu")
    assert isinstance(integ, GridADMM2D) and integ.free.dtype == torch.float64
    _, x, z, u = integ.start(integ.init_state())
    noise = np.random.default_rng(0).normal(scale=3e-3, size=tuple(u.shape))
    dxpu = (integ.gather(x) + u + torch.tensor(noise)).contiguous()
    z = z.contiguous()
    inputs = (z, dxpu, integ.free, integ.cells(z))
    args = (integ.mesh.ehat_np.reshape(-1), integ.w, integ.prox_tol, integ.prox_max_iters)
    kern = jp.make_prox_pallas2d(integ.mesh.ehat_np, integ.w, interpret=True)
    zj, ihj = kern.tiled_call(*(_tiles(t) for t in inputs), integ.prox_tol,
                              integ.prox_max_iters)
    jax_out = (np.asarray(zj).reshape(6, -1), np.asarray(ihj).reshape(-1))
    assert jax_out[0].dtype == np.float64
    return integ, inputs, args, jax_out, P.prox2d_plain(*inputs, *args)


def test_k1_plain_matches_jax_in_float64(k1_case):
    integ, (z, dxpu, free, cells), args, (zj, ihj), (zp, ihp) = k1_case
    assert zp.dtype == ihp.dtype == torch.float64
    np.testing.assert_allclose(ihp.numpy(), ihj, rtol=1e-12, atol=0)
    rows = [[cells[v * 16 + k] for k in range(16)] for v in range(3)]
    half_w2 = P._consts(integ.w, torch.float64)[1]
    e_j = P.energy_c(list(torch.tensor(zj)), rows, tuple(args[0]), list(dxpu), half_w2)[1]
    e_p = P.energy_c(list(zp), rows, tuple(args[0]), list(dxpu), half_w2)[1]
    np.testing.assert_allclose(e_p.numpy(), e_j.numpy(), rtol=1e-10, atol=0)
    np.testing.assert_allclose(zp.numpy(), zj, rtol=0, atol=1e-10)
    fixed = free.numpy() == 0
    np.testing.assert_array_equal(zp.numpy()[fixed], z.numpy()[fixed])


def test_k1_entry_runs_the_plain_version_in_float64(k1_case):
    """On CPU tensors the float64 entry is the plain version: no launch of
    either instantiation."""
    _, inputs, args, _, (zp, ihp) = k1_case
    before = (P.prox2d.launches, P.prox2d.launches_f64)
    za, iha = P.prox2d(*inputs, *args)
    assert (P.prox2d.launches, P.prox2d.launches_f64) == before
    assert torch.equal(za, zp) and torch.equal(iha, ihp)


def test_k1_constants_are_rounded_in_float64():
    """The constants the float64 kernel takes are the float64 products of
    the JAX kernel (prox_pallas2d.py:124, :346), not float32 roundings."""
    third, k_g2, k_dgddet, k_sm2a, k_sm2b = P._K2[torch.float64]
    c_d32 = 2.0 * np.sqrt(2.0)
    assert (third, k_g2, k_dgddet) == (1.0 / 3.0, (1.0 / 3.0) * c_d32, (1.5 * (1.0 / 3.0)) * c_d32)
    assert (k_sm2a, k_sm2b) == (0.5 * (1.0 / 3.0), ((0.5 - 1.0 / 3.0) * (1.0 - 1.5)) * c_d32)
    assert P._K2[torch.float32][0] == float(np.float32(1.0 / 3.0)) != third
    from mmadmm_tpu_torch.ops.newton import consts, eps_stall

    assert eps_stall(torch.float64) == 10.0 * np.finfo(np.float64).eps
    assert consts(3.5, torch.float64) == (3.5 * 3.5, 0.5 * 3.5 * 3.5, 1.0 / (3.5 * 3.5))


@pytest.mark.parametrize("bad", ["mixed", "float16"])
def test_kernels_refuse_other_dtypes(k1_case, bad):
    """The wrappers take all-float32 or all-float64 tensors: nothing is cast."""
    _, (z, dxpu, free, cells), args, _, _ = k1_case
    zb = z.float() if bad == "mixed" else z.half()
    with pytest.raises(ValueError):
        P.prox2d(zb, dxpu, free, cells, *args)
    with pytest.raises(ValueError):
        B.eg2d(zb, cells, args[0])
    with pytest.raises(ValueError):
        B.hess2d(zb, cells, args[0])


@pytest.fixture(scope="module")
def be_case():
    """K2's and K3's inputs (perturbed slot positions and their cells), and
    both packages' outputs."""
    _, integ = build_problem(ExperimentConfig(**dict(KW, method=2)), device="cpu")
    x = integ.mesh.X0
    noise = np.random.default_rng(3).normal(scale=2e-3, size=tuple(x.shape))
    z = integ.eg.gather(x + torch.tensor(noise)).contiguous()
    cells = integ.eg.cells(z)
    ehat = integ.mesh.ehat_np.reshape(-1)
    eg, hess = jp.make_be_kernels2d(ehat, interpret=True)
    g, ih = eg(_tiles(z), _tiles(cells))
    H = hess(_tiles(z), _tiles(cells))
    jax_out = (np.asarray(g).reshape(6, -1), np.asarray(ih).reshape(-1),
               np.asarray(H).reshape(21, -1))
    assert jax_out[2].dtype == np.float64
    return (z, cells, ehat), jax_out


def _close_per_slot(got, ref, rtol, atol_frac):
    assert np.isfinite(ref).all() and np.isfinite(got).all()
    scale = np.abs(ref).max(axis=0, keepdims=True)
    np.testing.assert_array_less(np.abs(got - ref), rtol * np.abs(ref) + atol_frac * scale
                                 + np.finfo(np.float64).tiny)


def test_k2_plain_matches_jax_in_float64(be_case):
    (z, cells, ehat), (gj, ihj, _) = be_case
    g, ih = B.eg2d_plain(z, cells, ehat)
    assert g.dtype == ih.dtype == torch.float64
    np.testing.assert_allclose(ih.numpy(), ihj, rtol=1e-12, atol=0)
    _close_per_slot(g.numpy(), gj, 1e-10, 1e-12)


def test_k3_plain_matches_jax_in_float64(be_case):
    (z, cells, ehat), (_, _, Hj) = be_case
    H = B.hess2d_plain(z, cells, ehat)
    assert H.dtype == torch.float64
    _close_per_slot(H.numpy(), Hj, 1e-10, 1e-12)


def test_k2_k3_entries_run_the_plain_versions_in_float64(be_case):
    (z, cells, ehat), _ = be_case
    before = (B.eg2d.launches, B.eg2d.launches_f64, B.hess2d.launches, B.hess2d.launches_f64)
    g, ih = B.eg2d(z, cells, ehat)
    H = B.hess2d(z, cells, ehat)
    assert (B.eg2d.launches, B.eg2d.launches_f64, B.hess2d.launches,
            B.hess2d.launches_f64) == before
    gp, ihp = B.eg2d_plain(z, cells, ehat)
    assert torch.equal(g, gp) and torch.equal(ih, ihp)
    assert torch.equal(H, B.hess2d_plain(z, cells, ehat))
