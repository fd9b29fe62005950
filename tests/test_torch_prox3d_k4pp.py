"""K4'' (``ops/prox3d.py``): the plain versions of the two remaining
flag combinations of the 3D prox kernel's call site
(``mmadmm_tpu/ops/prox_pallas3d.py:418``), ``prox3d_chord_plain`` (K4''a,
``chord=True, comp_mesh=False``) and ``prox3d_comp_plain`` (K4''b,
``chord=False, comp_mesh=True``), through the stock engine's element-major
entry.

* Against the JAX package's generic vmap prox on the same inputs (made
  with NumPy from a seed) at 3D SquareGrid nx=4 (K4''a) and 3D CompSquare
  nx=4 (K4''b), within the bands of tests/test_prox_pallas3d.py:88-108
  and :137-185: ``ih0`` within rtol 3e-5 (atol 1e-7), the regularized
  energies after the solve within rtol 2e-4 (atol 1e-6). The interpreted
  JAX kernel is not compiled here: one interpreted 3D variant takes about
  5 minutes and 15 GB on a CPU.
* Two exact identities: ``prox3d_comp_plain`` with every element's Ehat
  equal to the constant one is ``prox3d_plain``, and ``prox3d_chord_plain``
  is ``prox3d_chord_comp_plain`` fed the constant Ehat on every element,
  bit for bit (a Python float meets an f32 tensor as the f32 it rounds
  to, so the constant and the broadcast channels give the same products).
* The kernel choice of ``prox_elements`` and of ``build_problem``'s
  ``prox_chord``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.problems import build_problem as jax_build_problem

from _torch_threads import one_torch_thread  # noqa: F401
from mmadmm_tpu_torch import ExperimentConfig, build_problem
from mmadmm_tpu_torch.integrators.admm import ADMMIntegrator
from mmadmm_tpu_torch.ops import prox3d as P3
from mmadmm_tpu_torch.ops.monitor_grid import element_cell_rows

BASE = dict(test_type="SquareGrid", dim=3, method=0, nx=4, ny=4, nz=4, dt=5e-3, tau=0.1,
            dtype="float32")
# name: (config, prox_chord, seed)
CASES = {
    "chord_mon1": (dict(BASE, mon_type=1, rho=50.0), True, 0),
    "chord_mon2": (dict(BASE, mon_type=2, rho=50.0), True, 0),
    "comp": (dict(BASE, mon_type=5, rho=10.0, comp_mesh=True), False, 1),
}


@pytest.fixture(scope="module")
def inputs():
    cache = {}

    def get(case):
        if case not in cache:
            kw, chord, seed = CASES[case]
            mesh, integ = build_problem(ExperimentConfig(**kw), device="cpu", prox_chord=chord)
            z = mesh.gather(mesh.X0)
            rng = np.random.default_rng(seed)
            dxpu = z + torch.tensor(rng.normal(scale=1e-3, size=tuple(z.shape)),
                                    dtype=torch.float32)
            cache[case] = (kw, mesh, integ, z, dxpu)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_k4pp_plain_matches_jax_vmap(inputs, case):
    kw, mesh, integ, z, dxpu = inputs(case)
    before = (P3.prox3d_chord.launches, P3.prox3d_comp.launches)
    zp, ihp = mesh.prox(z, mesh.xi, dxpu, mesh.elem_free, 1e-5, 50)
    assert (P3.prox3d_chord.launches, P3.prox3d_comp.launches) == before  # CPU: plain
    jmesh, _ = jax_build_problem(JaxConfig(**kw, prox_backend="vmap"))
    zj, ihj = jmesh.prox(jnp.asarray(z.numpy()), jmesh.xi, jnp.asarray(dxpu.numpy()),
                         jmesh.elem_free, 1e-5, 50)
    np.testing.assert_allclose(ihp.numpy(), np.asarray(ihj), rtol=3e-5, atol=1e-7)

    def reg_energy(zz):
        e = np.asarray(jmesh._energy_e(jnp.asarray(zz), jmesh.xi, jmesh.grid))
        return e + 0.5 * mesh.w ** 2 * np.sum((dxpu.numpy() - zz) ** 2, axis=(1, 2))

    np.testing.assert_allclose(reg_energy(zp.numpy()), reg_energy(np.asarray(zj)), rtol=2e-4,
                               atol=1e-6)


def _channels(mesh, z, dxpu):
    nf = z.shape[0]

    def ch(a):
        return a.reshape(nf, 12).T.contiguous()

    args = (ch(z), ch(dxpu), ch(mesh.elem_free), element_cell_rows(mesh.grid, z))
    eh = mesh.ehat_np.reshape(-1)
    const = torch.tensor(eh, dtype=torch.float32)[:, None].expand(9, nf).contiguous()
    return args, eh, const


@pytest.mark.parametrize("case", ["chord_mon1", "chord_mon2"])
def test_comp_plain_with_the_constant_ehat_is_k4(inputs, case):
    _, mesh, integ, z, dxpu = inputs(case)
    args, eh, const = _channels(mesh, z, dxpu)
    tail = (integ.w, integ.prox_tol, integ.prox_max_iters)
    za, iha = P3.prox3d_plain(*args, eh, *tail)
    zb, ihb = P3.prox3d_comp_plain(*args, const, *tail)
    assert torch.equal(za, zb) and torch.equal(iha, ihb)


@pytest.mark.parametrize("case", ["chord_mon1", "chord_mon2"])
def test_chord_plain_is_k4c_with_the_constant_ehat(inputs, case):
    _, mesh, integ, z, dxpu = inputs(case)
    args, eh, const = _channels(mesh, z, dxpu)
    tail = (integ.w, integ.prox_tol, integ.prox_max_iters)
    za, iha = P3.prox3d_chord_plain(*args, eh, *tail)
    zb, ihb = P3.prox3d_chord_comp_plain(*args, const, *tail)
    assert torch.equal(za, zb) and torch.equal(iha, ihb)


@pytest.mark.parametrize("chord", [None, True, False])
@pytest.mark.parametrize("comp_mesh", [False, True])
def test_prox_chord_picks_the_variant(comp_mesh, chord, monkeypatch):
    """``build_problem(prox_chord=...)``: a 3D box mesh takes the stencil
    engine (K4) unless chord sweeps are asked for, then the stock engine
    (K4''a); a computational mesh takes the stock engine with K4' (chord
    sweeps, the default there) or K4''b. The element-major entry runs the
    variant of ``(chord, computational mesh)`` (on the CPU, its plain
    version)."""
    kw = dict(BASE, nx=2, ny=2, nz=2, mon_type=5 if comp_mesh else 1, comp_mesh=comp_mesh)
    mesh, integ = build_problem(ExperimentConfig(**kw), device="cpu", prox_chord=chord)
    want_chord = comp_mesh if chord is None else chord
    assert mesh.prox_backend == "pallas" and mesh.prox_chord == want_chord
    stencil = not comp_mesh and not want_chord
    assert (type(integ).__name__ == "SoAADMM3D") == stencil
    want = {(False, False): "prox3d_plain", (True, True): "prox3d_chord_comp_plain",
            (True, False): "prox3d_chord_plain", (False, True): "prox3d_comp_plain"}
    seen = []
    for name in want.values():
        real = getattr(P3, name)
        monkeypatch.setattr(P3, name, lambda *a, name=name, real=real: seen.append(name) or real(*a))
    z = mesh.gather(mesh.X0)
    mesh.prox(z, mesh.xi, z, mesh.elem_free, 1e-5, 2)
    assert seen == [want[want_chord, comp_mesh]]
    if not stencil:
        assert isinstance(integ, ADMMIntegrator) and not integ.j_carry
        with pytest.raises(ValueError, match="j_carry=True"):
            ADMMIntegrator(mesh, 5e-3, j_carry=True)
