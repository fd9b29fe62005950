"""The float64 builds of K4', K4''a and K4''b (``ops/prox3d.py``) on the CPU:
their plain versions in float64, which the kernels ``mm_prox3d_chord_comp_f64``,
``mm_prox3d_chord_f64`` and ``mm_prox3d_comp_f64`` repeat bit for bit on the
card (tests/test_torch_kernels.py, chip_smoke.py), through the stock
engine's kernel route in float64 (``prox_backend="pallas"``).

* Module tests, against the JAX package's float64 generic prox
  (``make_prox_solver``, the vmap route of its own ``build_problem``) on
  the same inputs: K4' at 3D CompSquare nx=4 (MonType 5, rho 10, on its
  computational mesh), K4''a at 3D SquareGrid nx=4 with ``prox_chord=True``
  (MonType 1, rho 50), K4''b at CompSquare nx=4 with ``prox_chord=False``.
  The inputs are those of tests/test_torch_prox3d_chord.py: ``z`` the
  gathered start positions and ``dxpu = z + N(0, 1e-3)`` from
  ``np.random.default_rng(1)``. Bands: ih0 within rtol 1e-12 (the same
  function of the same inputs; measured 1.2e-15); the regularized energies
  after the solve within rtol 1e-7 for the chord sweeps K4' and K4''a
  (they take the JAX prox's iterates here: measured 4.7e-16 and 1.3e-15)
  and 1e-6 for the Newton sweeps K4''b (measured 2.8e-7): two solvers
  stopped within the prox tolerance at iterates up to 5.0e-8 apart, where
  the analytic gradient the sweeps drive to zero is not the derivative of
  the interpolated energy (on the worst element the energy falls at some
  1e-3 along the gap while the gradient is 1.5e-7), so the energies part
  by that slope times the gap; fixed coordinates exactly unchanged. No
  interpreted Pallas kernel is compiled here:
  tests/test_torch_f64_prox3d.py holds K4's float64 plain version to the
  interpreted JAX kernel, and the identities below chain the three to it.
* Two exact identities in float64, bit for bit: ``prox3d_comp_plain``
  with every element's Ehat equal to the constant one is
  ``prox3d_plain``, and ``prox3d_chord_plain`` is
  ``prox3d_chord_comp_plain`` fed the constant Ehat on every element.
* A whole-step test: the stock engine at 3D CompSquare nx=4 in float64 on
  the kernel route (the plain version of K4' on the CPU) against the JAX
  package's float64 stock route (the generic prox with the carried chord
  Jacobian), both started from the same state through ``convert``, over 4
  steps. Bands: the same ADMM iteration counts, ``I_h`` within rel 1e-6
  and the final node positions within atol 1e-6 (measured: 4.8e-7 at step
  3, and 5.6e-7). They are the JAX package's own: its float64 kernel route
  (the interpreted K4' built in float64) and its vmap route part by the
  same 1.4e-7, 2.5e-7 and 4.8e-7 in ``I_h`` at steps 1-3 and 5.6e-7 in
  ``x``, while the port's kernel route stays within 4.4e-16 of the JAX
  kernel route (``scripts/stock_jax_gap.py comp3d_f64``, on a CPU): the
  carried chord Jacobian of the vmap route stops its prox at other
  iterates than the chord sweeps' entry Hessian.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.problems import build_problem as jax_build_problem

from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem, convert
from mmadmm_tpu_torch.integrators.admm import ADMMIntegrator
from mmadmm_tpu_torch.ops import prox3d as P3
from mmadmm_tpu_torch.ops.monitor_grid import element_cell_rows

TOL, MAX_ITERS = 1e-5, 50
STEPS = 4
BASE = dict(test_type="SquareGrid", dim=3, method=0, nx=4, ny=4, nz=4, dt=5e-3, tau=0.1,
            dtype="float64")
COMP = dict(BASE, mon_type=5, rho=10.0, comp_mesh=True)
SQUARE = dict(BASE, mon_type=1, rho=50.0)
# name: (JAX configuration, prox_chord, the plain version the route takes)
CASES = {
    "K4'": ("comp", None, "prox3d_chord_comp_plain"),
    "K4''a": ("square", True, "prox3d_chord_plain"),
    "K4''b": ("comp", False, "prox3d_comp_plain"),
}
CONFIGS = {"comp": COMP, "square": SQUARE}
# the regularized energies' band against the JAX generic prox (see above)
ENERGY_RTOL = {"K4'": 1e-7, "K4''a": 1e-7, "K4''b": 1e-6}


@pytest.fixture(scope="module")
def jax_meshes():
    """One JAX float64 build per configuration, on its generic route:
    ``(mesh, integrator, z, dxpu, its prox (z', ih0) on z and dxpu)``."""
    cache = {}

    def get(name):
        if name not in cache:
            jmesh, jinteg = jax_build_problem(JaxConfig(**CONFIGS[name]))
            assert jmesh.prox_backend == "vmap" and type(jinteg).__name__ == "ADMMIntegrator"
            z = np.asarray(jmesh.gather(jmesh.X0))
            assert z.dtype == np.float64
            rng = np.random.default_rng(1)
            dxpu = z + rng.normal(scale=1e-3, size=z.shape)
            zj, ihj = jmesh.prox(jnp.asarray(z), jmesh.xi, jnp.asarray(dxpu), jmesh.elem_free,
                                 TOL, MAX_ITERS)
            cache[name] = (jmesh, jinteg, z, dxpu, (np.asarray(zj), np.asarray(ihj)))
        return cache[name]

    return get


@pytest.fixture(scope="module")
def prox_runs(jax_meshes):
    """Each case's port prox (the kernel route's plain version, on the
    CPU) and the JAX float64 generic prox on the same inputs."""
    cache = {}

    def get(case):
        if case not in cache:
            name, chord, plain = CASES[case]
            jmesh, _, z, dxpu, jax_out = jax_meshes(name)
            kw = dict(CONFIGS[name], prox_backend="pallas")
            mesh, integ = build_problem(ExperimentConfig(**kw), device="cpu", prox_chord=chord)
            assert isinstance(integ, ADMMIntegrator) and mesh.prox_backend == "pallas"
            assert mesh.dtype == torch.float64
            zt, dt = torch.tensor(z), torch.tensor(dxpu)
            seen = []
            real = getattr(P3, plain)

            def spy(*a, **k):
                seen.append(plain)
                return real(*a, **k)

            launches = {fn: (fn.launches, fn.launches_f64) for fn in _kernels()}
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(P3, plain, spy)
                zp, ihp = mesh.prox(zt, mesh.xi, dt, mesh.elem_free, TOL, MAX_ITERS)
            assert seen == [plain]  # CPU tensors: the plain version, no launch
            assert {fn: (fn.launches, fn.launches_f64) for fn in _kernels()} == launches
            cache[case] = dict(mesh=mesh, jmesh=jmesh, z=z, dxpu=dxpu, port=(zp, ihp),
                               jax=jax_out)
        return cache[case]

    return get


def _kernels():
    return (P3.prox3d, P3.prox3d_chord_comp, P3.prox3d_chord, P3.prox3d_comp)


def _reg_energy(r, zz):
    """The regularized energies ``[NF]`` at element-major ``zz``, by the
    JAX package's element energy in float64."""
    jmesh = r["jmesh"]
    e = np.asarray(jmesh._energy_e(jnp.asarray(zz), jmesh.xi, jmesh.grid))
    return e + 0.5 * r["mesh"].w ** 2 * np.sum((r["dxpu"] - zz) ** 2, axis=(1, 2))


@pytest.mark.parametrize("case", list(CASES))
def test_ih0_matches_jax_in_float64(prox_runs, case):
    r = prox_runs(case)
    ihp = r["port"][1].numpy()
    assert ihp.dtype == np.float64
    np.testing.assert_allclose(ihp, r["jax"][1], rtol=1e-12, atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_regularized_energy_after_the_solve_matches_jax_in_float64(prox_runs, case):
    r = prox_runs(case)
    zp = r["port"][0].numpy()
    assert zp.dtype == np.float64 and np.isfinite(zp).all()
    np.testing.assert_allclose(_reg_energy(r, zp), _reg_energy(r, r["jax"][0]),
                               rtol=ENERGY_RTOL[case], atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_fixed_coordinates_stay_in_float64(prox_runs, case):
    r = prox_runs(case)
    fixed = r["mesh"].elem_free.numpy() == 0
    assert fixed.any()
    np.testing.assert_array_equal(r["port"][0].numpy()[fixed], r["z"][fixed])
    np.testing.assert_array_equal(r["jax"][0][fixed], r["z"][fixed])


def _channels(r):
    """The prox inputs of a box-mesh case as channels, its constant Ehat as
    9 floats, and the same Ehat broadcast to ``[9, NF]`` channels."""
    mesh = r["mesh"]
    z, dxpu = torch.tensor(r["z"]), torch.tensor(r["dxpu"])
    nf = z.shape[0]

    def ch(a):
        return a.reshape(nf, 12).T.contiguous()

    args = (ch(z), ch(dxpu), ch(mesh.elem_free), element_cell_rows(mesh.grid, z))
    eh = mesh.ehat_np.reshape(-1)
    const = torch.tensor(eh, dtype=torch.float64)[:, None].expand(9, nf).contiguous()
    tail = (mesh.w, TOL, MAX_ITERS)
    return args, eh, const, tail


def test_comp_plain_with_the_constant_ehat_is_k4_in_float64(prox_runs):
    args, eh, const, tail = _channels(prox_runs("K4''a"))
    assert args[0].dtype == torch.float64
    za, iha = P3.prox3d_plain(*args, eh, *tail)
    zb, ihb = P3.prox3d_comp_plain(*args, const, *tail)
    assert torch.equal(za, zb) and torch.equal(iha, ihb)


def test_chord_plain_is_k4c_with_the_constant_ehat_in_float64(prox_runs):
    args, eh, const, tail = _channels(prox_runs("K4''a"))
    za, iha = P3.prox3d_chord_plain(*args, eh, *tail)
    zb, ihb = P3.prox3d_chord_comp_plain(*args, const, *tail)
    assert torch.equal(za, zb) and torch.equal(iha, ihb)


@pytest.fixture(scope="module")
def step_runs(jax_meshes):
    """The JAX package's float64 stock route and the port's stock engine on
    the float64 kernel route (K4'), both from the JAX start state, over
    STEPS steps: ``(JAX [(ih, n_iters)], JAX final x, port infos, port
    final state)``."""
    jinteg = jax_meshes("comp")[1]
    s0 = jinteg.init_state()
    s, jax_infos = s0, []
    for _ in range(STEPS):
        s, info = jinteg.step(s)
        jax_infos.append((float(info.ih_start), int(info.n_iters)))
    mesh, integ = build_problem(ExperimentConfig(**COMP, prox_backend="pallas"), device="cpu")
    assert isinstance(integ, ADMMIntegrator) and mesh.prox_backend == "pallas"
    assert mesh.prox_chord and not integ.j_carry
    state = convert.load_admm_state(integ, dict(x=np.asarray(s0.x), x_prev=np.asarray(s0.x_prev),
                                                u_bar=np.asarray(s0.u_bar)))
    assert state.x.dtype == torch.float64
    infos = []
    for _ in range(STEPS):
        state, info = integ.step(state)
        infos.append(info)
    return jax_infos, np.asarray(s.x), infos, state


@pytest.mark.parametrize("k", range(STEPS))
def test_kernel_route_step_matches_the_jax_float64_route(step_runs, k):
    jax_infos, _, infos, _ = step_runs
    ih_j, it_j = jax_infos[k]
    assert infos[k].n_iters == it_j
    assert abs(infos[k].ih - ih_j) <= 1e-6 * abs(ih_j)


def test_kernel_route_final_state_matches_the_jax_float64_route(step_runs):
    _, x_j, infos, state = step_runs
    assert state.x.dtype == torch.float64
    np.testing.assert_allclose(state.x.numpy(), x_j, rtol=0, atol=1e-6)
    ih = [i.ih for i in infos]
    assert all(math.isfinite(v) for v in ih) and ih[-1] < ih[0]
