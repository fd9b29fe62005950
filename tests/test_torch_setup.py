"""Host set-up of the PyTorch port against the JAX package: geometry,
monitors, config, the monitor grid and the stencil engine's constants.

The port keeps its own copies of the JAX package's NumPy modules, so every
set-up array here must be bit-equal (tolerance 0) to the JAX package's on
the same config."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.config import load_experiment_config as jax_load_config
from mmadmm_tpu.geometry.glibc_rand import GlibcRand as JaxRand
from mmadmm_tpu.mesh import MovingMesh as JaxMesh
from mmadmm_tpu.monitors import MONITORS_2D as JAX_MON_2D
from mmadmm_tpu.monitors import MONITORS_3D as JAX_MON_3D
from mmadmm_tpu.ops.stencil2d import match_dense as jax_match_dense
from mmadmm_tpu.problems import build_geometry as jax_geometry
from mmadmm_tpu.runtime.native import grid_nn_map as jax_nn_map

from mmadmm_tpu_torch import ExperimentConfig, build_problem, load_experiment_config, problems
from mmadmm_tpu_torch.geometry.glibc_rand import GlibcRand
from mmadmm_tpu_torch.geometry.topology import build_boundary_faces
from mmadmm_tpu_torch.monitors import MONITORS_2D, MONITORS_3D
from mmadmm_tpu_torch.ops.stencil2d import match_dense
from mmadmm_tpu_torch.problems import build_geometry
from mmadmm_tpu_torch.runtime.device import resolve_device
from mmadmm_tpu_torch.runtime.nn import grid_nn_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(dim=2, mon_type=1, method=0, nx=16, ny=16, dt=5e-3, tau=0.1,
          rho=50.0, dtype="float32")
TYPES = ["SquareGrid", "Shoulder"]


@pytest.fixture(scope="module", params=TYPES)
def both(request):
    """(test_type, JAX MovingMesh, port (mesh, integrator)) at nx=16."""
    tt = request.param
    jcfg = JaxConfig(test_type=tt, **KW)
    X, F, mask, _ = jax_geometry(jcfg)
    from mmadmm_tpu.monitors import get_monitor

    jmesh = JaxMesh(X, F, mask, get_monitor(2, 1), rho=50.0, tau=0.1,
                    dtype=np.float32)
    mesh, integ = build_problem(ExperimentConfig(test_type=tt, **KW), device="cpu")
    return tt, (X, F, mask), jmesh, mesh, integ


def test_geometry_bit_equal(both):
    tt, (X, F, mask), _, _, _ = both
    Xp, Fp, maskp = build_geometry(ExperimentConfig(test_type=tt, **KW))
    np.testing.assert_array_equal(Xp, X)
    np.testing.assert_array_equal(Fp, F)
    np.testing.assert_array_equal(maskp, mask)


def test_mesh_arrays_bit_equal(both):
    _, _, jmesh, mesh, _ = both
    np.testing.assert_array_equal(mesh._F_np, jmesh._F_np)  # reoriented F
    np.testing.assert_array_equal(mesh.F.numpy(), np.asarray(jmesh.F))
    np.testing.assert_array_equal(mesh.X0.numpy(), np.asarray(jmesh.X0))
    np.testing.assert_array_equal(mesh.deg.numpy(), np.asarray(jmesh.deg))
    np.testing.assert_array_equal(mesh.dense_idx.numpy(), np.asarray(jmesh.dense_idx))
    np.testing.assert_array_equal(mesh.elem_free.numpy(), np.asarray(jmesh.elem_free))
    np.testing.assert_array_equal(
        build_boundary_faces(mesh._F_np, jmesh.mask_np), jmesh.boundary_faces)
    np.testing.assert_array_equal(mesh.ehat.numpy(), np.asarray(jmesh.ehat))
    assert mesh.w == jmesh.w


def test_monitor_grid_bit_equal(both):
    _, _, jmesh, mesh, _ = both
    np.testing.assert_array_equal(
        mesh.grid.cell_table.numpy(), np.asarray(jmesh.grid.cell_table)
    )
    for a, b in zip(mesh.grid.axes, jmesh.grid.axes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_nn_map_matches_native(both):
    """SciPy's cKDTree (the port) and the JAX package's map agree."""
    _, (X, _, _), _, _, _ = both
    lo, hi = X.min(0), X.max(0)
    n = int((X.shape[0] * 2) ** 0.5)
    np.testing.assert_array_equal(grid_nn_map(X, lo, hi, n), jax_nn_map(X, lo, hi, n))


def test_match_dense_bit_equal(both):
    _, _, jmesh, mesh, _ = both
    for a, b in zip(match_dense(16, 16, mesh._F_np), jax_match_dense(16, 16, jmesh._F_np)):
        np.testing.assert_array_equal(a, b)


def test_grid2d_constants_bit_equal(both):
    """The stencil engine's masks and x-update diagonal, against the JAX
    GridADMM2D's constants (its tiles are the port's [C, NFd] in the same
    memory order)."""
    from mmadmm_tpu.integrators.admm_grid2d import GridADMM2D as JaxGrid

    _, _, jmesh, _, integ = both
    jc = JaxGrid(jmesh, 5e-3, 16, 16)._consts
    np.testing.assert_array_equal(integ.swap_k.numpy(), np.asarray(jc["swap_k"]))
    np.testing.assert_array_equal(integ.alive_k.numpy(), np.asarray(jc["alive_k"]))
    np.testing.assert_array_equal(integ.free.numpy(), np.asarray(jc["free_t"]).reshape(6, -1))
    np.testing.assert_array_equal(integ.valid.numpy(), np.asarray(jc["valid_t"]).reshape(-1))
    np.testing.assert_array_equal(integ.t_diag.numpy(), np.asarray(jc["t_diag"]))


@pytest.mark.parametrize("seed", [1, 69, 12345])
def test_glibc_rand_stream_bit_equal(seed):
    np.testing.assert_array_equal(GlibcRand(seed).rand_array(500), JaxRand(seed).rand_array(500))


@pytest.mark.parametrize("dim,idx", [(2, i) for i in range(6)] + [(3, i) for i in range(6)])
def test_monitors_bit_equal(dim, idx):
    rng = np.random.default_rng(idx)
    x = rng.uniform(0.0, 1.0, size=(64, dim))
    port = (MONITORS_2D if dim == 2 else MONITORS_3D)[idx]
    ref = (JAX_MON_2D if dim == 2 else JAX_MON_3D)[idx]
    np.testing.assert_array_equal(port(x), ref(x))


def test_config_loads_like_jax():
    path = os.path.join(REPO, "Experiments", "InputFiles", "Monitor3320r.json")
    a, b = load_experiment_config(path, method=0), jax_load_config(path, method=0)
    for f in ("test_type", "dim", "mon_type", "method", "n_steps", "admm_iter",
              "dt_tol", "dt", "tau", "rho", "nx", "ny", "mask_file", "base_dir", "name"):
        assert getattr(a, f) == getattr(b, f), f


def _skewed(X):
    """A monitor that is not symmetric, ``M[0, 1] = 0.5 + x`` (every
    shipped monitor is symmetric): the narrow cell path's input."""
    D = X.shape[1]
    M = np.broadcast_to(np.eye(D), (X.shape[0], D, D)).copy()
    M[:, 0, 1] = 0.5 + X[:, 0]
    return M


@pytest.mark.parametrize("change,engine", [
    # methods 1 and 2 off the stencil engine's gate and in 3D take the
    # compact path (ROADMAP A11, A12; these four cases raised before). 3D
    # at nx=4: 3D Shoulder 16x16x4 at this dt diverges in both packages
    # (backward Euler's first I_h is NaN in float32 in the JAX package too)
    (dict(method=1, nx=8, ny=8), "EulerIntegrator"),
    (dict(method=2, nx=8, ny=8), "BackwardEulerIntegrator"),
    (dict(dim=3, nx=4, ny=4, nz=4, method=1), "EulerIntegrator"),
    (dict(dim=3, nx=4, ny=4, nz=4, method=2), "BackwardEulerIntegrator"),
])
def test_euler_routes_off_the_stencil_engine_run_compact(change, engine):
    kw = dict(KW, test_type="Shoulder")
    kw.update(change)
    _, integ = build_problem(ExperimentConfig(**kw), device="cpu")
    assert type(integ).__name__ == engine and type(integ.eg).__name__ == "CompactEG"
    state, info = integ.step(integ.init_state())
    assert np.isfinite(info.ih) and bool(torch.isfinite(state.x).all())


@pytest.mark.parametrize("change,item", [
    (dict(n_devices=2), "A15"),
    # the CLI's nDevices argument: more than one card
    (dict(cli_devices=2), "A15"),
    # a monitor that is not symmetric needs the narrow cell path, in 2D and 3D
    (dict(monitor=_skewed), "A16"), (dict(dim=3, nz=4, monitor=_skewed), "A16"),
])
def test_unported_routes_name_their_roadmap_item(change, item, monkeypatch):
    kw = dict(KW, test_type="Shoulder")
    kw.update(change)
    monitor = kw.pop("monitor", None)
    if monitor is not None:
        monkeypatch.setattr(problems, "get_monitor", lambda dim, mon_type: monitor)
    cli_devices = kw.pop("cli_devices", None)
    with pytest.raises(NotImplementedError, match=item):
        if cli_devices is not None:
            from mmadmm_tpu_torch.run import main

            main([os.path.join(REPO, "Experiments", "InputFiles", "Monitor3320r.json"), "0",
                  str(cli_devices), "--device", "cpu"])
        build_problem(ExperimentConfig(**kw), device="cpu")


@pytest.mark.parametrize("change,engine,backend", [
    # a 3D computational mesh: the stock engine with K4' (ROADMAP A14, B5)
    (dict(dim=3, nz=4, comp_mesh=True), "ADMMIntegrator", "pallas"),
    # 4*nx*ny not a multiple of 1024: off the stencil gate, the stock engine
    # with K1 (ROADMAP A10)
    (dict(nx=8, ny=8), "ADMMIntegrator", "pallas"),
    (dict(), "GridADMM2D", "pallas"), (dict(dim=3, nz=4), "SoAADMM3D", "pallas"),
    (dict(prox_backend="pallas"), "GridADMM2D", "pallas"),
    # float64 box meshes on the stencil gate: the stencil engines with K1
    # and K4 built in float64 (ROADMAP A20, B7, B9); the mesh's own route
    # stays the JAX package's float64 default, the generic prox
    (dict(dim=3, nz=4, dtype="float64"), "SoAADMM3D", "vmap"),
    (dict(dtype="float64"), "GridADMM2D", "vmap"),
    (dict(dtype="float64", prox_backend="pallas"), "GridADMM2D", "pallas"),
    (dict(dim=3, nz=4, dtype="float64", prox_backend="pallas"), "SoAADMM3D", "pallas"),
    # the generic route (ROADMAP A10, A14): float64 off the stencil gate,
    # "vmap" and 2D computational meshes take the stock engine
    (dict(comp_mesh=True), "ADMMIntegrator", "vmap"),
    (dict(nx=8, ny=8, dtype="float64"), "ADMMIntegrator", "vmap"),
    (dict(prox_backend="vmap"), "ADMMIntegrator", "vmap"),
    (dict(dtype="float64", prox_backend="vmap"), "ADMMIntegrator", "vmap"),
    (dict(dim=3, nz=4, dtype="float64", prox_backend="vmap"), "ADMMIntegrator", "vmap"),
    (dict(dim=3, nz=4, dtype="float64", test_type="LevelSet"), "ADMMIntegrator", "vmap"),
    (dict(dtype="float64", comp_mesh=True), "ADMMIntegrator", "vmap"),
    # "pallas" in float64 off the stencil gate: the stock engine with K1 or
    # K4 built in float64 behind their element-major entries
    (dict(nx=8, ny=8, dtype="float64", prox_backend="pallas"), "ADMMIntegrator", "pallas"),
    (dict(dim=3, nz=4, dtype="float64", test_type="LevelSet", prox_backend="pallas"),
     "ADMMIntegrator", "pallas"),
    # LevelSet meshes: the stock engine, on the kernels in float32 (K1, K4)
    (dict(dim=3, nz=4, test_type="LevelSet"), "ADMMIntegrator", "pallas"),
    (dict(test_type="LevelSet"), "ADMMIntegrator", "pallas"),
    # chord sweeps on a 3D box mesh: the stock engine with K4''a (ROADMAP B6)
    (dict(dim=3, nz=4, prox_chord=True), "ADMMIntegrator", "pallas"),
    # "pallas" in float64 on the stock engine: K4' on a 3D computational
    # mesh, K4''a with chord sweeps on a 3D box mesh, K4''b with Newton
    # sweeps on a computational mesh (ROADMAP B10)
    (dict(dtype="float64", dim=3, nz=4, comp_mesh=True, prox_backend="pallas"),
     "ADMMIntegrator", "pallas"),
    (dict(dtype="float64", dim=3, nz=4, prox_chord=True, prox_backend="pallas"),
     "ADMMIntegrator", "pallas"),
    (dict(dtype="float64", dim=3, nz=4, comp_mesh=True, prox_chord=False,
          prox_backend="pallas"), "ADMMIntegrator", "pallas"),
    # "auto" in float64 on a 3D computational mesh stays on the generic prox
    (dict(dtype="float64", dim=3, nz=4, comp_mesh=True), "ADMMIntegrator", "vmap"),
])
def test_ported_routes_build_their_engine(change, engine, backend):
    kw = dict(KW, test_type="Shoulder")
    kw.update(change)
    chord = kw.pop("prox_chord", None)
    mesh, integ = build_problem(ExperimentConfig(**kw), device="cpu", prox_chord=chord)
    assert type(integ).__name__ == engine
    assert mesh.prox_backend == backend
    assert mesh.comp_mesh == bool(change.get("comp_mesh"))


@pytest.mark.parametrize("change,item", [
    (dict(comp_mesh=True), "computational-mesh"),
    (dict(dtype="float64", comp_mesh=True), "computational-mesh"),
], ids=["comp_mesh", "float64_comp_mesh_2d"])
def test_kernel_route_refuses_what_no_kernel_computes(change, item):
    """``prox_backend="pallas"`` where no kernel computes the function: a
    2D computational mesh (K1 has no computational-mesh mode), in either
    dtype."""
    kw = dict(KW, test_type="Shoulder", prox_backend="pallas")
    kw.update(change)
    chord = kw.pop("prox_chord", None)
    with pytest.raises(ValueError, match="pallas") as err:
        build_problem(ExperimentConfig(**kw), device="cpu", prox_chord=chord)
    assert item in str(err.value)


def test_device_default_is_cuda():
    """Entry points default to CUDA and never fall back to the CPU."""
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither JAX nor the JAX package."""
    code = (
        "import sys, pkgutil, importlib, mmadmm_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(mmadmm_tpu_torch.__path__, 'mmadmm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mmadmm_tpu.'))"
        " or m == 'mmadmm_tpu']\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("name,headers", [
    ("prox2d", {"huang2d.cuh", "dual.cuh", "stage.cuh"}),
    ("be2d", {"huang2d.cuh", "dual.cuh", "stage.cuh"}),
    ("prox3d", {"huang3d.cuh", "dual.cuh", "stage.cuh"}),
])
def test_build_hash_covers_every_header(name, headers, tmp_path, monkeypatch):
    """Each library's hash covers its source and every header it includes,
    so an edit to a header (the float and double builds share them)
    builds the library anew."""
    import shutil

    from mmadmm_tpu_torch import cuda_build

    assert set(cuda_build._sources(name)) == {f"{name}.cu"} | headers
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", str(csrc))
    before = cuda_build._paths(name)
    with open(csrc / "dual.cuh", "a") as f:
        f.write("\n// an edit\n")
    assert cuda_build._paths(name)[0] != before[0]
