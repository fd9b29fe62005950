"""The plain chord sweep (``mmadmm_tpu_torch/ops/newton.py::chord_sweep``)
retires an element on its gradient norm before it solves with the cached
Hessian and tries that step, as kernels K4' and K4''a do.

The JAX package's sweep (``mmadmm_tpu/ops/prox_pallas2d.py::
make_chord_sweeps``) solves with the cached Hessian and tries the step at
alpha 1 for every active element, refreshes where that trial is rejected,
and only then retires the elements whose gradient norm is below ``tol``
(from the second sweep on), without moving them; a retiring element does
not refresh. So the port's sweep must give the same bits as that order
while solving only for the element-sweeps that do not retire: its count of
cached solves is the element-sweeps minus the gradient-norm retirements of
the JAX order, and its Hessians are one per element at entry plus one per
refresh, counted where the plain version builds them. A first sweep whose
cached step is rejected backtracks that step: its refresh would build the
entry Hessian again at the same z. Inputs: the step-0
prox inputs of 3D CompSquare nx=4 (K4''s plain version, rho 10) and of 3D
SquareGrid nx=4 with ``prox_chord=True`` (K4''a's), their duals perturbed
by a seeded normal so that elements take several sweeps and some refresh;
each in float32 and in float64 (the float64 builds of K4' and K4''a sweep
in the same order). No JAX is needed: the JAX order is written out here with the sweep's own
pieces."""

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem
from mmadmm_tpu_torch.ops import newton as N
from mmadmm_tpu_torch.ops import prox3d as P3
from mmadmm_tpu_torch.ops.monitor_grid import element_cell_rows

CASES = {
    "K4' 3D CompSquare": (P3.prox3d_chord_comp_plain,
                          dict(mon_type=5, rho=10.0, comp_mesh=True)),
    "K4''a 3D SquareGrid": (P3.prox3d_chord_plain, dict(mon_type=1, rho=50.0)),
}


def jax_order_sweep(not_first, zc, Hc, fns, edet_fn, inv_w2, tol, stats=None, grad=None):
    """``make_chord_sweeps``'s order: the cached solve and the alpha-1
    trial of every active element first, the refresh where the trial is
    rejected and the element does not retire (in the first sweep too), the
    retire test after; counts its gradient-norm retirements in
    ``stats["gnorm_retired"]``."""
    n = len(zc)
    tri = N.tri_index(n)
    grad_fn, _, energy_fn = fns(slice(None))
    g, _, e0 = grad_fn(zc) if grad is None else grad
    gnorm = N._gnorm(g)
    det_floor = torch.clamp_max(edet_fn(zc), 0.0)
    H = [[None] * n for _ in range(n)]
    for t, (i, j) in enumerate(tri):
        H[i][j] = Hc[t]
    p = N._solve(H, g, inv_w2)
    ok1 = N._trial_ok(energy_fn, edet_fn, [zc[i] + p[i] for i in range(n)], e0, det_floor)
    step = torch.stack([torch.where(ok1, p[i], 0.0) for i in range(n)])
    if not_first:
        ok1 = ok1 | (gnorm < tol)
    rows = torch.nonzero(~ok1).squeeze(1)
    Hc = Hc.clone()
    if rows.numel():
        _, hess_fn, energy_r = fns(rows)
        zr = [zi[rows] for zi in zc]
        H2 = hess_fn(zr)
        p2 = N._solve(H2, [gi[rows] for gi in g], inv_w2)
        alpha = N._backtrack(zr, p2, energy_r, edet_fn, e0[rows], det_floor[rows])
        step[:, rows] = torch.stack([alpha * pi for pi in p2])
        Hc[:, rows] = torch.stack([H2[i][j] for i, j in tri])
    step_inf = N.rmax([torch.abs(s) for s in step])
    # an element retires on gnorm < tol from the second sweep on, before it
    # moves, or after a stalled move
    active_now = ~(gnorm < tol) if not_first else torch.ones_like(e0, dtype=torch.bool)
    stalled = N._stalled(step_inf, zc)
    stats["gnorm_retired"] = stats.get("gnorm_retired", 0) + int((~active_now).sum())
    z_new = [torch.where(active_now, zc[i] + step[i], zc[i]) for i in range(n)]
    return z_new, active_now & ~stalled, Hc


def _inputs(kw, dtype):
    cfg = ExperimentConfig(**dict(dict(test_type="SquareGrid", dim=3, method=0, nx=4, ny=4,
                                       nz=4, dt=5e-3, tau=0.1, dtype=dtype,
                                       prox_backend="pallas"), **kw))
    _, integ = build_problem(cfg, device="cpu", prox_chord=True)
    assert integ.mesh.prox_backend == "pallas" and integ.mesh.dtype == getattr(torch, dtype)
    _, x, z, u = integ.start(integ.init_state())
    noise = np.random.default_rng(0).normal(scale=3e-3, size=tuple(u.shape))
    dxpu = integ.gather(x) + u + torch.tensor(noise, dtype=u.dtype)
    nf = z.shape[0]

    def ch(a):
        return a.reshape(nf, -1).T.contiguous()

    inputs = (ch(z), ch(dxpu), ch(integ.free), element_cell_rows(integ.mesh.grid, z))
    if integ.mesh.comp_mesh:
        return inputs + (ch(integ.mesh.elem_ehat),), (integ.w, integ.prox_tol,
                                                      integ.prox_max_iters)
    return inputs, (integ.mesh.ehat_np.reshape(-1), integ.w, integ.prox_tol,
                    integ.prox_max_iters)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_chord_sweep_solves_only_where_it_steps(case, dtype, monkeypatch):
    plain, kw = CASES[case]
    inputs, args = _inputs(kw, dtype)
    built, solved = [], []
    hess, solve = P3.hess_c3, N._solve

    def counted_hess(z, *rest):
        built.append(z[0].shape[0])
        return hess(z, *rest)

    def counted_solve(H, g, inv_w2):
        solved.append(g[0].shape[0])
        return solve(H, g, inv_w2)

    monkeypatch.setattr(P3, "hess_c3", counted_hess)
    monkeypatch.setattr(N, "_solve", counted_solve)
    stats = {}
    z_out, ih0 = plain(*inputs, *args, stats=stats)
    n_built, n_solved = sum(built), sum(solved)
    monkeypatch.setattr(N, "_solve", solve)

    monkeypatch.setattr(P3, "chord_sweep", jax_order_sweep)
    ref = {}
    z_ref, ih_ref = plain(*inputs, *args, stats=ref)
    n = inputs[0].shape[1]
    assert torch.equal(z_out, z_ref) and torch.equal(ih0, ih_ref)
    assert ref["element_sweeps"] == stats["element_sweeps"]
    assert stats["sweeps"] >= 3 and ref["gnorm_retired"] > 0 and stats["refreshes"] >= 1
    assert stats["gnorm_retired"] == ref["gnorm_retired"]
    # one cached solve per element-sweep that does not retire, one more per refresh
    assert n_solved == stats["element_sweeps"] - ref["gnorm_retired"] + stats["refreshes"]
    assert n_built - n == stats["hessians"] - n == stats["refreshes"]
