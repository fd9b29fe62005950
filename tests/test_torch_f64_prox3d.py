"""Kernel K4 in float64: its plain PyTorch version (``mmadmm_tpu_torch/
ops/prox3d.py::prox3d_plain``) against the JAX package's component-form
Pallas prox built in float64 (``make_prox_pallas3d``, interpreter mode on
the CPU), on the same inputs. The float64 kernel itself is held to the
plain version bit for bit in tests/test_torch_kernels.py and by
chip_smoke.py, on the card.

Inputs, made with numpy from a seed: the step-0 prox inputs of the port's
float64 3D stencil engine at SquareGrid nx=4 (the radial bump, the 48-wide
cell table) and Shoulder nx=4 (the identity monitor, a constant grid; the
carve and its fixed nodes), their duals perturbed, in one batch of 1,536
slots with SquareGrid's Ehat (the JAX kernel takes Ehat as a constant),
so that one interpreted kernel compiles (some two minutes on a CPU), under
the lock of tests/_torch_soa3d.py.

The comparison runs as one case a mesh, each on its half of the batch
(so that the file's five tests put it among the files that pytest-xdist's
``--dist loadfile`` hands out before the four-test files).

Bands, float64 (the same operations on both sides, ordered a little
differently by XLA and PyTorch): ih0 within rtol 1e-12, the regularized
energies after the solve within rtol 1e-10 and the iterates within atol
1e-10. Measured on an Intel Xeon CPU: 1.8e-15, 8.9e-16 and 1.1e-16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmadmm_tpu.ops import prox_pallas3d as jp

from _torch_soa3d import jax_compile_lock
from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem
from mmadmm_tpu_torch.integrators.admm_soa import SoAADMM3D
from mmadmm_tpu_torch.ops import newton as N
from mmadmm_tpu_torch.ops import prox3d as P


def _slots(test_type, mon_type, rng):
    """``(integrator, channel inputs [C, 768])`` of one mesh."""
    _, integ = build_problem(ExperimentConfig(
        test_type=test_type, dim=3, mon_type=mon_type, method=0, nx=4, ny=4, nz=4, dt=5e-3,
        tau=0.1, rho=50.0, dtype="float64"), device="cpu")
    assert isinstance(integ, SoAADMM3D) and integ.free.dtype == torch.float64
    _, x, z, u = integ.start(integ.init_state())
    noise = torch.tensor(rng.normal(scale=3e-3, size=tuple(u.shape)))
    z = z.contiguous()
    return integ, (z, (integ.gather(x) + u + noise).contiguous(), integ.free, integ.cells(z))


@pytest.fixture(scope="module")
def batch():
    """``(ehat, w, tol, max_iters, channel inputs [C, 1536], live slots)``,
    with SquareGrid's Ehat and prox parameters (Shoulder's w is the same)."""
    rng = np.random.default_rng(0)
    parts = [_slots(tt, mon, rng) for tt, mon in (("SquareGrid", 1), ("Shoulder", 0))]
    integ = parts[0][0]
    assert parts[0][1][0].shape[1] == parts[1][1][0].shape[1]  # two halves, one a mesh
    inputs = tuple(torch.cat([p[1][i] for p in parts], dim=1).contiguous() for i in range(4))
    assert parts[1][0].w == integ.w
    live = torch.cat([p[0].valid for p in parts]) > 0
    return (integ.mesh.ehat_np.reshape(-1), integ.w, integ.prox_tol, integ.prox_max_iters,
            inputs, live)


@pytest.fixture(scope="module")
def kernel_run(batch):
    """One eager call of the interpreted float64 JAX kernel, padded to whole
    tiles with clones of the first slots, as the JAX engine pads."""
    ehat, w, tol, max_iters, inputs, _ = batch
    n = inputs[0].shape[1]
    T = -(-n // 1024)

    def tiles(t):
        a = t.numpy()
        a = np.concatenate([a, a[:, :T * 1024 - n]], axis=1)
        return jnp.asarray(a.reshape(a.shape[0], T, 8, 128))

    with jax_compile_lock():
        pf = jp.make_prox_pallas3d(np.asarray(ehat).reshape(3, 3), w, interpret=True)
        zo, ih0 = pf.tiled_call(*(tiles(t) for t in inputs), tol, max_iters)
        zo, ih0 = np.asarray(zo), np.asarray(ih0)
    assert zo.dtype == np.float64
    return zo.reshape(12, -1)[:, :n], ih0.reshape(-1)[:n]


@pytest.fixture(scope="module")
def plain_run(batch):
    ehat, w, tol, max_iters, inputs, _ = batch
    stats = {}
    zp, ihp = P.prox3d_plain(*inputs, ehat, w, tol, max_iters, stats=stats)
    return zp, ihp, stats


@pytest.mark.parametrize("half", [0, 1], ids=["SquareGrid", "Shoulder"])
def test_k4_plain_matches_jax_in_float64(batch, kernel_run, plain_run, half):
    """On each mesh's half of the batch."""
    ehat, w, _, _, (z, dxpu, free, cells), live = batch
    zk, ihk = kernel_run
    zp, ihp, _ = plain_run
    assert zp.dtype == ihp.dtype == torch.float64
    n = z.shape[1] // 2
    sl = slice(half * n, (half + 1) * n)
    np.testing.assert_allclose(ihp.numpy()[sl], ihk[sl], rtol=1e-12, atol=0)
    rows = P._rows(cells)
    half_w2 = N.consts(w, torch.float64)[1]
    e_p = P.energy_c3(list(zp), rows, tuple(ehat), list(dxpu), half_w2)[1].numpy()
    e_k = P.energy_c3(list(torch.tensor(zk)), rows, tuple(ehat), list(dxpu), half_w2)[1].numpy()
    np.testing.assert_allclose(e_p[sl], e_k[sl], rtol=1e-10, atol=0)
    np.testing.assert_allclose(zp.numpy()[:, sl], zk[:, sl], rtol=0, atol=1e-10)


def test_k4_moves_only_free_coordinates_in_float64(batch, plain_run):
    _, _, _, _, (z, _, free, _), live = batch
    zp, _, stats = plain_run
    fixed = free.numpy() == 0
    assert fixed.any() and (~live).any()  # Shoulder's carve and fixed nodes are in the batch
    np.testing.assert_array_equal(zp.numpy()[fixed], z.numpy()[fixed])
    assert torch.isfinite(zp).all() and stats["hessians"] > 0


def test_k4_entry_runs_the_plain_version_in_float64(batch, plain_run):
    ehat, w, tol, max_iters, inputs, _ = batch
    cut = tuple(t[:, :300].contiguous() for t in inputs)
    before = (P.prox3d.launches, P.prox3d.launches_f64)
    za, iha = P.prox3d(*cut, ehat, w, tol, max_iters)
    assert (P.prox3d.launches, P.prox3d.launches_f64) == before
    zb, ihb = P.prox3d_plain(*cut, ehat, w, tol, max_iters)
    assert torch.equal(za, zb) and torch.equal(iha, ihb)


def test_k4_constants_are_rounded_in_float64():
    """``Consts3`` of the float64 kernel: the JAX kernel's Python-float
    products, unrounded (prox_pallas3d.py:143, :173, :182-184)."""
    third, d_dp2 = 1.0 / 3.0, 3.0 ** 2.25
    k = P._consts3(2.0, 1e-5, torch.float64)
    assert k == (4.0, 2.0, 0.25, 1e-5, third, third * d_dp2, 1.5 * third * d_dp2, 0.5 * third,
                 (0.5 - third) * (1.0 - 1.5) * d_dp2)
    assert P._consts3(2.0, 1e-5)[3:5] == (float(np.float32(1e-5)), float(np.float32(third)))
