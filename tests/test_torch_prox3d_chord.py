"""Kernel K4' (the 3D chord prox on a computational mesh): its plain
PyTorch version (``mmadmm_tpu_torch/ops/prox3d.py::
prox3d_chord_comp_plain``, through the element-major entry
``prox_elements``) against the JAX package's component-form Pallas prox
with ``comp_mesh=True, chord=True`` (``mmadmm_tpu/ops/prox_pallas3d.py``,
interpreter mode on the CPU). The kernel itself is held to the plain
version in tests/test_torch_kernels.py and by chip_smoke.py, on the card.

Inputs: those of tests/test_prox_pallas3d.py:137-151, 3D SquareGrid nx=4
with the MEx53D monitor (mon_type 5), rho 10, on its computational mesh:
``z`` the gathered start positions and ``dxpu = z + N(0, 1e-3)`` from
``np.random.default_rng(1)``.

Bands, those of tests/test_torch_prox3d.py: ih0 within rtol 2e-5, atol
1e-7; the regularized energies after the solve within rtol 1e-4, atol
1e-6 (iterates of two Newton solvers may differ where the energies
agree); fixed coordinates exactly unchanged. The interpreted kernel
compiles once (about five minutes and 15 GB on a CPU), outside the lock
of tests/_torch_soa3d.py so that it overlaps the K4 compiles, and its
memory is handed back afterwards. Its executable is the one
tests/test_prox_pallas3d.py's chord call compiles; under pytest-xdist the
run's compile cache (tests/_torch_soa3d.py::share_interpreted_compiles)
hands it to whichever of the two comes second.

The chord sweep itself (``ops/newton.py::chord_sweep``) is held on one
element to the Newton sweep: a rejected cached step refreshes the
Hessian and then takes the Newton sweep's step exactly, an accepted one
keeps the cache."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.ops import prox_pallas3d as jp
from mmadmm_tpu.problems import build_problem as jax_build_problem

from _torch_soa3d import release_jax_memory
from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem
from mmadmm_tpu_torch.integrators.admm import ADMMIntegrator
from mmadmm_tpu_torch.ops import newton as N
from mmadmm_tpu_torch.ops import prox3d as P
from mmadmm_tpu_torch.ops.monitor_grid import element_cell_rows

TOL, MAX_ITERS = 1e-5, 50
KW = dict(test_type="SquareGrid", dim=3, mon_type=5, method=0, nx=4, ny=4, nz=4, dt=5e-3,
          tau=0.1, rho=10.0, dtype="float32", comp_mesh=True)


@pytest.fixture(scope="module")
def setup():
    """The JAX mesh's inputs as numpy, and the port's mesh on the CPU."""
    jmesh, _ = jax_build_problem(JaxConfig(**KW, prox_backend="pallas"))
    z = np.asarray(jmesh.gather(jmesh.X0))
    rng = np.random.default_rng(1)
    dxpu = (z + rng.normal(scale=1e-3, size=z.shape)).astype(np.float32)
    mesh, integ = build_problem(ExperimentConfig(**KW), device="cpu")
    return jmesh, dict(z=z, dxpu=dxpu, free=np.asarray(jmesh.elem_free),
                       xi=np.asarray(jmesh.xi)), mesh, integ


@pytest.fixture(scope="module")
def kernel_run(setup):
    """One eager call of the interpreted JAX K4'."""
    jmesh, a, _, _ = setup
    try:
        pf = jp.make_prox_pallas3d(jmesh.ehat, jmesh.w, comp_mesh=True, chord=True,
                                   interpret=True)
        zo, ih0 = pf(jmesh.grid, jnp.asarray(a["z"]), jmesh.xi, jnp.asarray(a["dxpu"]),
                     jmesh.elem_free, TOL, MAX_ITERS)
        return np.asarray(zo), np.asarray(ih0)
    finally:
        release_jax_memory()


@pytest.fixture(scope="module")
def port_run(setup):
    _, a, mesh, _ = setup
    t = {k: torch.tensor(v) for k, v in a.items()}
    return P.prox_elements(mesh.grid, t["z"], t["xi"], t["dxpu"], t["free"], mesh.w, TOL,
                           MAX_ITERS)


def _reg_energy(mesh, z, dxpu):
    """The regularized energies ``[NF]`` at element-major z."""
    nf = z.shape[0]
    ch = z.reshape(nf, 12).T.contiguous()
    rows = P._rows(element_cell_rows(mesh.grid, z))
    eh = list(mesh.elem_ehat.reshape(nf, 9).T)
    return P.energy_c3(list(ch), rows, eh, list(dxpu.reshape(nf, 12).T),
                       N.consts(mesh.w)[1])[1].numpy()


def test_port_inputs_match_jax(setup):
    """The port builds the same mesh: positions, free mask, xi, the cell
    table of the monitor grid, and routes the config to the stock engine."""
    jmesh, a, mesh, integ = setup
    assert isinstance(integ, ADMMIntegrator) and mesh.comp_mesh
    np.testing.assert_array_equal(mesh.gather(mesh.X0).numpy(), a["z"])
    np.testing.assert_array_equal(mesh.elem_free.numpy(), a["free"])
    np.testing.assert_array_equal(mesh.xi.numpy(), a["xi"])
    np.testing.assert_array_equal(mesh.grid.cell_table.numpy(),
                                  np.asarray(jmesh.grid.cell_table))


def test_ih0_matches_jax(kernel_run, port_run):
    np.testing.assert_allclose(port_run[1].numpy(), kernel_run[1], rtol=2e-5, atol=1e-7)


def test_regularized_energy_after_the_solve_matches_jax(setup, kernel_run, port_run):
    _, a, mesh, _ = setup
    dxpu = torch.tensor(a["dxpu"])
    e_p = _reg_energy(mesh, port_run[0], dxpu)
    e_k = _reg_energy(mesh, torch.tensor(kernel_run[0]), dxpu)
    np.testing.assert_allclose(e_p, e_k, rtol=1e-4, atol=1e-6)


def test_fixed_coordinates_stay(setup, kernel_run, port_run):
    _, a, _, _ = setup
    fixed = a["free"] == 0
    assert fixed.any()
    np.testing.assert_array_equal(port_run[0].numpy()[fixed], a["z"][fixed])
    np.testing.assert_array_equal(kernel_run[0][fixed], a["z"][fixed])


def test_entry_runs_the_plain_version_on_the_cpu(setup):
    """On CPU tensors the entry point is the plain version and launches no
    kernel; the element-major entry is the channel one, transposed."""
    _, a, mesh, _ = setup
    nf = a["z"].shape[0]
    t = {k: torch.tensor(v) for k, v in a.items()}

    def ch(v):
        return v.reshape(nf, 12).T.contiguous()

    eh = mesh.elem_ehat.reshape(nf, 9).T.contiguous()
    cells = element_cell_rows(mesh.grid, t["z"])
    before = P.prox3d_chord_comp.launches
    za, iha = P.prox3d_chord_comp(ch(t["z"]), ch(t["dxpu"]), ch(t["free"]), cells, eh,
                                  mesh.w, TOL, MAX_ITERS)
    stats = {}
    zb, ihb = P.prox3d_chord_comp_plain(ch(t["z"]), ch(t["dxpu"]), ch(t["free"]), cells, eh,
                                        mesh.w, TOL, MAX_ITERS, stats=stats)
    assert P.prox3d_chord_comp.launches == before
    assert torch.equal(za, zb) and torch.equal(iha, ihb)
    assert stats["sweeps"] > 1 and stats["element_sweeps"] > nf
    ze, ihe = P.prox_elements(mesh.grid, t["z"], t["xi"], t["dxpu"], t["free"], mesh.w, TOL,
                              MAX_ITERS)
    assert torch.equal(ze, za.T.reshape(nf, 4, 3)) and torch.equal(ihe, iha)


@pytest.mark.parametrize("bad", ["shape", "dtype", "ehat_rows", "strided"])
def test_entry_rejects_bad_inputs(setup, bad):
    _, a, mesh, _ = setup
    nf = a["z"].shape[0]
    ch = {k: torch.tensor(a[k]).reshape(nf, 12).T[:, :64].contiguous()
          for k in ("z", "dxpu", "free")}
    cells = element_cell_rows(mesh.grid, torch.tensor(a["z"]))[:, :64].contiguous()
    eh = mesh.elem_ehat.reshape(nf, 9).T[:, :64].contiguous()
    if bad == "shape":
        ch["dxpu"] = ch["dxpu"][:, :32].contiguous()
    elif bad == "dtype":
        ch["z"] = ch["z"].double()
    elif bad == "ehat_rows":
        eh = eh[:6].contiguous()
    else:
        eh = mesh.elem_ehat.reshape(nf, 9).T[:, :128][:, ::2]
    with pytest.raises(ValueError):
        P.prox3d_chord_comp(ch["z"], ch["dxpu"], ch["free"], cells, eh, mesh.w, TOL,
                            MAX_ITERS)


def _one_element(setup, e):
    """Element ``e``'s channel lists and its element functions."""
    _, a, mesh, _ = setup
    nf = a["z"].shape[0]
    t = {k: torch.tensor(a[k]).reshape(nf, 12).T[:, e:e + 1].contiguous()
         for k in ("z", "dxpu", "free")}
    cells = P._rows(element_cell_rows(mesh.grid, torch.tensor(a["z"]))[:, e:e + 1])
    eh = list(mesh.elem_ehat.reshape(nf, 9).T[:, e:e + 1])
    w2, half_w2, inv_w2 = N.consts(mesh.w)
    d, fr = list(t["dxpu"]), list(t["free"])
    fns = (lambda zz: P.grad_c3(zz, cells, eh, d, w2, half_w2, fr),
           lambda zz: P.hess_c3(zz, cells, eh, d, w2, half_w2, fr),
           lambda zz: P.energy_c3(zz, cells, eh, d, half_w2)[1])
    return list(t["z"]), fns, inv_w2


def _free_element(setup):
    """The first element with every coordinate free."""
    return int(np.flatnonzero((setup[1]["free"].reshape(-1, 12) == 1).all(1))[0])


def test_chord_sweep_refreshes_a_rejected_step(setup):
    """A cached Hessian whose step overshoots (a hundredth of the true
    one: alpha-1 step 100 times the Newton step) is rejected; the element
    then caches the Hessian at z and takes the Newton sweep's step and
    retire decision, bit for bit."""
    zc, fns, inv_w2 = _one_element(setup, _free_element(setup))
    H = fns[1](zc)
    tri = N.tri_index(12)
    exact = torch.stack([H[i][j] for i, j in tri])
    cached = exact * 0.01
    g, _, e0 = fns[0](zc)
    p_cached = N._solve([[cached[tri.index((i, j))] if j <= i else None for j in range(12)]
                         for i in range(12)], g, inv_w2)
    ok = N._trial_ok(fns[2], P.edet_c3, [zc[i] + p_cached[i] for i in range(12)], e0,
                     torch.clamp_max(P.edet_c3(zc), 0.0))
    assert not bool(ok)  # the cached step is rejected: the refresh branch runs
    z_c, keep_c, h_new = N.chord_sweep(True, zc, cached, lambda rows: fns, P.edet_c3,
                                       inv_w2, N.f32(TOL))
    z_n, keep_n = N.newton_sweep(True, zc, lambda rows: fns, P.edet_c3, inv_w2, N.f32(TOL))
    assert torch.equal(h_new, exact)
    assert all(torch.equal(a, b) for a, b in zip(z_c, z_n))
    assert torch.equal(keep_c, keep_n)
    assert not all(torch.equal(a, b) for a, b in zip(z_c, zc))  # it moved


def test_chord_sweep_keeps_an_accepted_step(setup):
    """With the exact Hessian cached, the step at alpha 1 is accepted and
    the cache stays; the step is the undamped Newton step."""
    zc, fns, inv_w2 = _one_element(setup, _free_element(setup))
    H = fns[1](zc)
    cached = torch.stack([H[i][j] for i, j in N.tri_index(12)])
    g, _, _ = fns[0](zc)
    p = N._solve(H, g, inv_w2)
    z_c, _, h_new = N.chord_sweep(False, zc, cached, lambda rows: fns, P.edet_c3, inv_w2,
                                  N.f32(TOL))
    assert torch.equal(h_new, cached)
    assert all(torch.equal(a, b + c) for a, b, c in zip(z_c, zc, p))
