"""The stock element-major engine end to end: the port's ``ADMMIntegrator``
(``mmadmm_tpu_torch/integrators/admm.py``) against the JAX package's
``ADMMIntegrator``, both started from the same state through
``mmadmm_tpu_torch.convert.load_admm_state``.

Cases:

* 2D, 12 steps, with ``prox_backend="pallas"`` (K1 in interpreter mode):
  a FromFile mesh, written with the JAX package's ``geometry.io`` writers
  from a 2D SquareGrid nx=8 mesh, run with MonType 5 and Monitor3320r's
  dt, rho and AdmmIter (the extrapolation predictor from step 3, up to 8
  ADMM iterations a step); and 2D SquareGrid nx=8 with the anisotropic
  layer monitor, off the stencil engine's gate (its energy rises at step
  10, so step 11 takes the rise guard's Euler predictor).
* 3D SquareGrid nx=4 on its computational mesh, MonType 5, rho 10 (the
  3DMonitor3 family), 4 steps, so step 3 takes the extrapolation branch.
  The JAX side runs its generic vmap prox here: its stock step with the
  interpreted chord kernel inside compiles for minutes and about 15 GB on
  a CPU (the kernel alone takes 5 minutes), too long for the tier-1 run.
  The port's K4' plain version is held to the interpreted JAX kernel
  itself in tests/test_torch_prox3d_chord.py.

Bands, those of tests/_torch_soa3d.py:123-129: the same ``n_iters``;
``I_h`` within rel 2e-6; ``x`` within ``X_ATOL`` (2e-6 absolute);
``steps``, ``rose`` and ``rises`` equal. They hold against the JAX
kernel route (2D SquareGrid) and against the JAX vmap route (3D, whose
own band against the kernel route is looser, tests/test_prox_pallas3d.py:
120-133).

The FromFile case runs at Monitor3320r's weak regularization (rho 5,
w^2 = 1.25) and large dt (0.05), where the prox's f32 iterates part
between any two implementations: one boundary element of the first prox
call stops 2.4e-4 apart between the port and the JAX kernel (its
regularized energies agree to 5.5e-5), and the extrapolating predictor
carries such differences on. The JAX package's own two routes (kernel
and vmap) part on this case too, by up to 4.8e-4 in ``x`` and 1.4e-5 in
``I_h`` over 12 steps and in 6 of 12 iteration counts. So here the test
also runs the JAX vmap route and holds the port to the JAX kernel route
no less closely than the JAX package's two routes hold to each other: at
each step ``I_h`` within rel 2e-6 or within the largest relative gap of
the two routes so far, ``x`` within ``X_ATOL`` or within their largest
gap so far, no more steps with another ``n_iters`` than the two routes
have so far, and ``steps``, ``rose`` and ``rises`` equal."""

import math
import os

import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.config import load_experiment_config as jax_load_config
from mmadmm_tpu.geometry import io as jax_io
from mmadmm_tpu.problems import build_geometry as jax_geometry
from mmadmm_tpu.problems import build_problem as jax_build_problem

import _torch_soa3d as S
from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem, convert, load_experiment_config
from mmadmm_tpu_torch.geometry import io as port_io
from mmadmm_tpu_torch.integrators.admm import ADMMIntegrator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M3320R = os.path.join(REPO, "Experiments", "InputFiles", "Monitor3320r.json")
_2D = dict(dim=2, method=0, tau=0.1, dtype="float32")
CASES = {
    "fromfile2d": (dict(_2D, test_type="FromFile", mon_type=5, dt=0.05, rho=5.0,
                        admm_iter=100, triangles_file="tri.txt", pnts_file="pnts.txt",
                        mask_file="mask.txt"), 12, "pallas"),  # held to the JAX routes' gap
    "square2d": (dict(_2D, test_type="SquareGrid", mon_type=2, nx=8, ny=8, dt=5e-3,
                      rho=50.0), 12, "pallas"),
    "comp3d": (dict(test_type="SquareGrid", dim=3, mon_type=5, method=0, nx=4, ny=4, nz=4,
                    dt=5e-3, tau=0.1, rho=10.0, dtype="float32", comp_mesh=True), 4, "vmap"),
}
STEP_CASES = [(c, k) for c, (_, steps, _) in CASES.items() for k in range(steps)]


def _write_fromfile(base):
    """The FromFile case's mesh: 2D SquareGrid nx=8 through the JAX
    package's writers."""
    X, F, mask, _ = jax_geometry(JaxConfig(test_type="SquareGrid", dim=2, nx=8, ny=8))
    jax_io.write_triangles(os.path.join(base, "tri.txt"), F)
    jax_io.write_points(os.path.join(base, "pnts.txt"), X)
    jax_io.write_mask(os.path.join(base, "mask.txt"), mask)


def _jax_run(kw, steps, backend):
    """The JAX stock engine over ``steps`` steps, as NumPy: the start state
    and per step ``(ih, n_iters, x, steps, rose, rises)``."""
    jmesh, jinteg = jax_build_problem(JaxConfig(**kw, prox_backend=backend))
    assert type(jinteg).__name__ == "ADMMIntegrator"
    assert jmesh.prox_backend == backend
    s0 = jinteg.init_state()
    s, out = s0, []
    for _ in range(steps):
        s, info = jinteg.step(s)
        out.append((float(info.ih_start), int(info.n_iters), np.asarray(s.x), int(s.steps),
                    bool(s.rose), int(s.rises)))
    start = dict(x=np.asarray(s0.x), x_prev=np.asarray(s0.x_prev), u_bar=np.asarray(s0.u_bar))
    return start, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's JAX and port runs, computed once on first use."""
    base = str(tmp_path_factory.mktemp("fromfile"))
    _write_fromfile(base)
    cache = {}

    def get(case):
        if case not in cache:
            kw, steps, backend = CASES[case]
            if kw["test_type"] == "FromFile":
                kw = dict(kw, base_dir=base)
            start, jax_out = _jax_run(kw, steps, backend)
            # the JAX package's other route, for the case held to their gap
            gap = _jax_run(kw, steps, "vmap")[1] if case == "fromfile2d" else None
            _, integ = build_problem(ExperimentConfig(**kw), device="cpu")
            state = convert.load_admm_state(integ, start)
            port_out = []
            for _ in range(steps):
                state, info = integ.step(state)
                port_out.append((info, state))
            cache[case] = dict(kw=kw, start=start, jax=jax_out, port=port_out, integ=integ,
                               gap=gap)
        return cache[case]

    return get


@pytest.mark.parametrize("case,k", STEP_CASES)
def test_step_matches_jax(runs, case, k):
    r = runs(case)
    ih_j, it_j, x_j, steps_j, rose_j, rises_j = r["jax"][k]
    info, state = r["port"][k]
    assert (state.steps, state.rose, state.rises) == (steps_j, rose_j, rises_j)
    ih_tol, x_tol = 2e-6 * abs(ih_j), S.X_ATOL
    if r["gap"] is None:
        assert info.n_iters == it_j
    else:
        pairs = list(zip(r["gap"][:k + 1], r["jax"]))
        ih_tol = max(ih_tol, max(abs(v[0] / j[0] - 1.0) for v, j in pairs) * abs(ih_j))
        x_tol = max(x_tol, max(float(np.abs(v[2] - j[2]).max()) for v, j in pairs))
        port_off = sum(p.n_iters != j[1] for (p, _), j in zip(r["port"][:k + 1], r["jax"]))
        jax_off = sum(v[1] != j[1] for v, j in zip(r["gap"][:k + 1], r["jax"]))
        assert port_off <= jax_off
    assert abs(info.ih - ih_j) <= ih_tol
    np.testing.assert_allclose(state.x.numpy(), x_j, rtol=0, atol=x_tol)


@pytest.mark.parametrize("case", list(CASES))
def test_energy_falls_and_stays_finite(runs, case):
    r = runs(case)
    ih = [info.ih for info, _ in r["port"]]
    state = r["port"][-1][1]
    assert all(math.isfinite(v) for v in ih) and ih[-1] < ih[0]
    assert torch.isfinite(state.x).all()
    assert r["integ"].energy(state) < ih[0]


@pytest.mark.parametrize("case", list(CASES))
def test_build_problem_routes_to_the_stock_engine(runs, case):
    r = runs(case)
    integ = r["integ"]
    assert isinstance(integ, ADMMIntegrator)
    assert integ.mesh.comp_mesh == bool(r["kw"].get("comp_mesh"))
    state = convert.load_admm_state(integ, r["start"])
    np.testing.assert_array_equal(state.x.numpy(), r["start"]["x"])
    np.testing.assert_array_equal(state.u.numpy(), r["start"]["u_bar"])
    assert state.steps == 0 and state.ih_last == math.inf and not state.rose
    own = integ.init_state()
    np.testing.assert_array_equal(own.x.numpy(), r["start"]["x"])


def test_the_rise_guard_is_reached(runs):
    """The 2D SquareGrid case's energy rises once; both packages see it."""
    r = runs("square2d")
    assert any(rose for *_, rose, _ in r["jax"])
    assert any(state.rose for _, state in r["port"])


def test_read_mesh_matches_jax_on_monitor3320r():
    cfg = jax_load_config(M3320R, method=0)
    paths = [os.path.join(cfg.base_dir, p)
             for p in (cfg.triangles_file, cfg.pnts_file, cfg.mask_file)]
    for a, b in zip(port_io.read_mesh(*paths), jax_io.read_mesh(*paths)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_monitor3320r_set_up_matches_jax():
    """Monitor3320r as shipped, in float32: the port routes it to the stock
    engine (K1 behind its element-major entry) with the JAX package's mesh
    arrays and monitor grid, bit for bit, and the same initial energy to
    rtol 1e-6."""
    cfg = load_experiment_config(M3320R, method=0)
    cfg.dtype = "float32"
    mesh, integ = build_problem(cfg, device="cpu")
    assert isinstance(integ, ADMMIntegrator)
    assert (mesh.n_pnts, mesh.n_elements) == (133_116, 265_004)
    jcfg = jax_load_config(M3320R, method=0)
    jcfg.dtype, jcfg.prox_backend = "float32", "pallas"
    jmesh, jinteg = jax_build_problem(jcfg)
    assert type(jinteg).__name__ == "ADMMIntegrator"
    np.testing.assert_array_equal(mesh.F.numpy(), np.asarray(jmesh.F))
    np.testing.assert_array_equal(mesh.X0.numpy(), np.asarray(jmesh.X0))
    np.testing.assert_array_equal(mesh.elem_free.numpy(), np.asarray(jmesh.elem_free))
    np.testing.assert_array_equal(mesh.grid.cell_table.numpy(),
                                  np.asarray(jmesh.grid.cell_table))
    assert float(mesh.energy(mesh.X0)) == pytest.approx(float(jmesh.energy(jmesh.X0)),
                                                        rel=1e-6)


def test_comp_mesh_gradient_matches_jax():
    """The predictor's gradient on a 3D computational mesh uses each
    element's Ehat: the port's ``MovingMesh.gradient`` against the JAX
    package's at perturbed positions, within the bands of
    tests/test_torch_ops3d.py (Ih rtol 2e-5; gradient rtol 3e-4, atol 3e-5
    of its largest entry)."""
    kw = CASES["comp3d"][0]
    jmesh, _ = jax_build_problem(JaxConfig(**kw, prox_backend="pallas"))
    mesh, _ = build_problem(ExperimentConfig(**kw), device="cpu")
    rng = np.random.default_rng(3)
    x = (mesh._X_np + rng.normal(scale=2e-3, size=mesh._X_np.shape)).astype(np.float32)
    ih, g = mesh.gradient(torch.tensor(x))
    jih, jg = jmesh.gradient(x, False)
    assert float(ih) == pytest.approx(float(jih), rel=2e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(g.numpy(), jg, rtol=3e-4, atol=3e-5 * np.abs(jg).max())
    np.testing.assert_array_equal(
        mesh.elem_ehat.numpy(),
        np.swapaxes(np.asarray(jmesh.xi)[:, 1:] - np.asarray(jmesh.xi)[:, :1], 1, 2))


def test_3d_fromfile_runs_k4_on_the_stock_engine(tmp_path):
    """A 3D mesh that is neither a box mesh nor a computational mesh (a
    FromFile copy of 3D SquareGrid nx=2, the radial bump) takes the stock
    engine with K4 behind the element-major entry: the entry equals K4 on
    channels, and two steps lower the energy."""
    from mmadmm_tpu_torch.ops import prox3d as P3
    from mmadmm_tpu_torch.ops.monitor_grid import element_cell_rows

    X, F, mask, _ = jax_geometry(JaxConfig(test_type="SquareGrid", dim=3, nx=2, ny=2, nz=2))
    jax_io.write_triangles(os.path.join(tmp_path, "tri.txt"), F)
    jax_io.write_points(os.path.join(tmp_path, "pnts.txt"), X)
    jax_io.write_mask(os.path.join(tmp_path, "mask.txt"), mask)
    cfg = ExperimentConfig(test_type="FromFile", dim=3, mon_type=1, method=0, dt=5e-3,
                           tau=0.1, rho=50.0, dtype="float32", base_dir=str(tmp_path),
                           triangles_file="tri.txt", pnts_file="pnts.txt",
                           mask_file="mask.txt")
    mesh, integ = build_problem(cfg, device="cpu")
    assert isinstance(integ, ADMMIntegrator) and not mesh.comp_mesh
    _, x, z, u = integ.start(integ.init_state())
    dxpu = integ.gather(x) + u
    ze, ihe = integ.prox(z, dxpu)
    nf = z.shape[0]

    def ch(a):
        return a.reshape(nf, 12).T.contiguous()

    zc, ihc = P3.prox3d(ch(z), ch(dxpu), ch(integ.free), element_cell_rows(mesh.grid, z),
                        mesh.ehat_np.reshape(-1), integ.w, integ.prox_tol,
                        integ.prox_max_iters)
    assert torch.equal(ze, zc.T.reshape(nf, 4, 3)) and torch.equal(ihe, ihc)
    state, ih = integ.init_state(), []
    for _ in range(2):
        state, info = integ.step(state)
        ih.append(info.ih)
    assert all(math.isfinite(v) for v in ih) and integ.energy(state) < ih[0]
