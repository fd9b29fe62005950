"""The plain Newton sweep (``mmadmm_tpu_torch/ops/newton.py::newton_sweep``)
retires an element on its gradient norm before it builds that element's
Hessian, as kernels K4 and K4''b do.

The JAX package's sweep (``mmadmm_tpu/ops/prox_pallas2d.py::
make_newton_sweeps``) builds the Hessian, solves and backtracks for every
active element and only then retires the ones whose gradient norm is below
``tol`` (from the second sweep on), without moving them. So the port's
sweep must give the same bits as that order while building a Hessian only
for the element-sweeps that do not retire: its count of Hessian builds
(counted where the plain version builds them) is the element-sweeps minus
the gradient-norm retirements of the JAX order. Inputs: the step-0 prox
inputs of 3D Shoulder and 3D SquareGrid at nx=4 (K4's plain version) and
of Shoulder nx=16 (K1's), their duals perturbed by a seeded normal so that
elements take several sweeps. No JAX is needed: the JAX order is written
out here with the sweep's own pieces."""

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem
from mmadmm_tpu_torch.ops import newton as N
from mmadmm_tpu_torch.ops import prox2d as P2
from mmadmm_tpu_torch.ops import prox3d as P3

CASES = {
    "3D Shoulder": (P3, "hess_c3", dict(test_type="Shoulder", dim=3, mon_type=0, nx=4, ny=4,
                                        nz=4)),
    "3D SquareGrid": (P3, "hess_c3", dict(test_type="SquareGrid", dim=3, mon_type=1, nx=4,
                                          ny=4, nz=4)),
    "2D Shoulder": (P2, "hess_c", dict(test_type="Shoulder", dim=2, mon_type=1, nx=16, ny=16)),
}


def jax_order_sweep(not_first, zc, fns, edet_fn, inv_w2, tol, stats):
    """``make_newton_sweeps``'s order: the step of every active element
    first, the retire test after; counts its gradient-norm retirements in
    ``stats["gnorm_retired"]``."""
    grad_fn, hess_fn, energy_fn = fns(slice(None))
    g, _, e0 = grad_fn(zc)
    gnorm = N._gnorm(g)
    p = N._solve(hess_fn(zc), g, inv_w2)
    det_floor = torch.clamp_max(edet_fn(zc), 0.0)
    alpha = N._backtrack(zc, p, energy_fn, edet_fn, e0, det_floor)
    step_inf = alpha * N.rmax([torch.abs(pi) for pi in p])
    # an element retires on gnorm < tol from the second sweep on, before it
    # moves, or after a stalled move
    active_now = ~(gnorm < tol) if not_first else torch.ones_like(e0, dtype=torch.bool)
    stalled = N._stalled(step_inf, zc)
    stats["gnorm_retired"] = stats.get("gnorm_retired", 0) + int((~active_now).sum())
    z_new = [torch.where(active_now, zc[i] + alpha * p[i], zc[i]) for i in range(len(zc))]
    return z_new, active_now & ~stalled


def _inputs(kw):
    cfg = ExperimentConfig(**dict(dict(method=0, dt=5e-3, tau=0.1, rho=50.0, dtype="float32"),
                                  **kw))
    _, integ = build_problem(cfg, device="cpu")
    _, x, z, u = integ.start(integ.init_state())
    noise = np.random.default_rng(0).normal(scale=3e-3, size=tuple(u.shape))
    dxpu = (integ.gather(x) + u + torch.tensor(noise, dtype=torch.float32)).contiguous()
    args = (integ.mesh.ehat_np.reshape(-1), integ.w, integ.prox_tol, integ.prox_max_iters)
    return (z.contiguous(), dxpu, integ.free, integ.cells(z)), args


@pytest.mark.parametrize("case", list(CASES))
def test_plain_sweep_builds_a_hessian_only_where_it_steps(case, monkeypatch):
    module, hess_name, kw = CASES[case]
    plain = module.prox3d_plain if module is P3 else module.prox2d_plain
    inputs, args = _inputs(kw)
    built = []
    hess = getattr(module, hess_name)

    def counted(z, *rest):
        built.append(z[0].shape[0])
        return hess(z, *rest)

    monkeypatch.setattr(module, hess_name, counted)
    stats = {}
    z_out, ih0 = plain(*inputs, *args, stats=stats)
    n_built = sum(built)

    monkeypatch.setattr(module, "newton_sweep", jax_order_sweep)
    ref = {}
    z_ref, ih_ref = plain(*inputs, *args, stats=ref)
    assert torch.equal(z_out, z_ref) and torch.equal(ih0, ih_ref)
    assert ref["element_sweeps"] == stats["element_sweeps"]
    assert ref["gnorm_retired"] > 0
    assert n_built == stats["hessians"] == stats["element_sweeps"] - ref["gnorm_retired"]
    assert stats["gnorm_retired"] == ref["gnorm_retired"]
