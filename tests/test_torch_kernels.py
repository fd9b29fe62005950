"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card and ``nvcc`` and skips without
them; the file imports no JAX, so it also runs on the card's machine:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Bands for K1 (``csrc/prox2d.cu`` vs ``ops/prox2d.py::prox2d_plain``),
those of tests/test_prox_pallas2d.py:95-119: ih0 within rtol 2e-5, the
regularized energies after the solve within rtol 5e-5. For K2 and K3
(``csrc/be2d.cu`` vs ``ops/be2d.py::eg2d_plain`` / ``hess2d_plain``),
those of tests/test_torch_be2d.py: ih within rtol 2e-5, the gradient and
the Hessian channels within rtol 1e-4 and atol 1e-6 of the slot's
largest entry. For K4 (``csrc/prox3d.cu`` vs ``ops/prox3d.py::
prox3d_plain``), those of tests/test_prox_pallas3d.py:88-108: ih0 within
rtol 2e-5, the regularized energies after the solve within rtol 1e-4 and
atol 1e-6; the same for K4' (``csrc/prox3d.cu`` vs ``ops/prox3d.py::
prox3d_chord_comp_plain``, tests/test_torch_prox3d_chord.py), on the
stock engine's inputs. K4, K4', K4''a and K4''b (``prox3d``,
``prox3d_chord_comp``, ``prox3d_chord``, ``prox3d_comp``) are also held
bit for bit to their plain versions, and so are the float64 builds of K1,
K2, K3, K4, K4', K4''a and K4''b."""

import pytest
import torch

from mmadmm_tpu_torch import ExperimentConfig, build_problem
from mmadmm_tpu_torch.integrators.run_loop import run
from mmadmm_tpu_torch.ops import be2d as B
from mmadmm_tpu_torch.ops import prox2d as P
from mmadmm_tpu_torch.ops import prox3d as P3
from mmadmm_tpu_torch.ops.newton import consts


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _problem(nx=16, method=0):
    return build_problem(ExperimentConfig(
        test_type="Shoulder", dim=2, mon_type=1, method=method, nx=nx, ny=nx,
        dtype="float32"))


def _inputs(integ):
    _, x, z, u = integ.start(integ.init_state())
    dxpu = (integ.gather(x) + u).contiguous()
    args = (integ.mesh.ehat_np.reshape(-1), integ.w, integ.prox_tol, integ.prox_max_iters)
    return (z.contiguous(), dxpu, integ.free, integ.cells(z)), args


def _check_pair(inputs, args, zk, ihk):
    z, dxpu, free, cells = inputs
    zp, ihp = P.prox2d_plain(*inputs, *args)
    torch.testing.assert_close(ihk, ihp, rtol=2e-5, atol=1e-8)
    rows = [[cells[v * 16 + k] for k in range(16)] for v in range(3)]
    half_w2 = P._consts(args[1])[1]
    ek = P.energy_c(list(zk), rows, tuple(args[0]), list(dxpu), half_w2)[1]
    ep = P.energy_c(list(zp), rows, tuple(args[0]), list(dxpu), half_w2)[1]
    torch.testing.assert_close(ek, ep, rtol=5e-5, atol=1e-7)


def test_k1_matches_plain():
    _card()
    _, integ = _problem()
    inputs, args = _inputs(integ)
    before = P.prox2d.launches
    zk, ihk = P.prox2d(*inputs, *args)
    torch.cuda.synchronize()
    assert P.prox2d.launches == before + 1
    _check_pair(inputs, args, zk, ihk)


@pytest.mark.parametrize("n", [1, 127, 129, 1000])
def test_k1_ragged_sizes(n):
    """Element counts that are not a multiple of the block: the kernel
    masks the ragged edge itself."""
    _card()
    _, integ = _problem()
    inputs, args = _inputs(integ)
    cut = tuple(t[:, :n].contiguous() for t in inputs)
    zk, ihk = P.prox2d(*cut, *args)
    torch.cuda.synchronize()
    _check_pair(cut, args, zk, ihk)


def test_main_path_launches_k1_once_per_admm_iteration():
    _card()
    _, integ = _problem()
    P.prox2d.launches = 0
    iters = []
    _, trace, steps = run(integ, integ.init_state(), cap=3, dt_tol=0.0,
                          on_step=lambda k, info: iters.append(info.n_iters))
    assert P.prox2d.launches == sum(iters) > 0
    assert trace[steps - 1] < trace[0]


def test_cuda_tensors_never_take_the_plain_version():
    """A CUDA tensor of the wrong type raises; there is no fallback."""
    _card()
    _, integ = _problem()
    (z, dxpu, free, cells), args = _inputs(integ)
    with pytest.raises(ValueError):
        P.prox2d(z.double(), dxpu, free, cells, *args)


def _be_inputs():
    _, integ = _problem(method=2)
    z = integ.eg.gather(integ.mesh.X0).contiguous()
    return z, integ.eg.cells(z), integ.mesh.ehat_np.reshape(-1)


def _close_per_slot(got, ref, rtol, atol_frac):
    assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
    ok = torch.isfinite(ref)
    scale = torch.where(ok, ref.abs(), 0.0).amax(0, keepdim=True)
    err = torch.where(ok, (got - ref).abs(), 0.0)
    assert bool((err <= rtol * ref.abs() + atol_frac * scale).all())


def _check_be(z, cells, ehat):
    before = (B.eg2d.launches, B.hess2d.launches)
    gk, ihk = B.eg2d(z, cells, ehat)
    Hk = B.hess2d(z, cells, ehat)
    torch.cuda.synchronize()
    assert (B.eg2d.launches, B.hess2d.launches) == (before[0] + 1, before[1] + 1)
    gp, ihp = B.eg2d_plain(z, cells, ehat)
    Hp = B.hess2d_plain(z, cells, ehat)
    _close_per_slot(ihk[None], ihp[None], 2e-5, 0.0)
    _close_per_slot(gk, gp, 1e-4, 1e-6)
    _close_per_slot(Hk, Hp, 1e-4, 1e-6)


def test_k2_k3_match_plain():
    _card()
    _check_be(*_be_inputs())


@pytest.mark.parametrize("n", [1, 127, 129, 1000])
def test_k2_k3_ragged_sizes(n):
    _card()
    z, cells, ehat = _be_inputs()
    _check_be(z[:, :n].contiguous(), cells[:, :n].contiguous(), ehat)


def test_euler_paths_launch_k2_and_k3_as_counted():
    """Explicit Euler: one K2 launch per step. Backward Euler: one K3
    launch per step, and K2 once per Newton iteration plus three times a
    step (the explicit-Euler guess, the first residual, the post-step
    energy)."""
    _card()
    for method in (1, 2):
        _, integ = _problem(method=method)
        B.eg2d.launches = B.hess2d.launches = 0
        infos = []
        _, trace, steps = run(integ, integ.init_state(), cap=3, dt_tol=0.0,
                              on_step=lambda k, info: infos.append(info))
        assert steps == 3 and trace[2] < trace[0]
        if method == 1:
            assert (B.eg2d.launches, B.hess2d.launches) == (3, 0)
        else:
            newton = sum(i.n_newton for i in infos)
            assert (B.eg2d.launches, B.hess2d.launches) == (newton + 3 * 3, 3)


def test_cuda_tensors_never_take_the_plain_k2_k3():
    _card()
    z, cells, ehat = _be_inputs()
    for fn in (B.eg2d, B.hess2d):
        with pytest.raises(ValueError):
            fn(z.double(), cells, ehat)
        with pytest.raises(ValueError):
            fn(z, cells.cpu(), ehat)


def _problem3(test_type="SquareGrid", mon_type=1):
    return build_problem(ExperimentConfig(
        test_type=test_type, dim=3, mon_type=mon_type, method=0, nx=4, ny=4, nz=4,
        dtype="float32"))


def _check_pair3(inputs, args, zk, ihk):
    z, dxpu, free, cells = inputs
    zp, ihp = P3.prox3d_plain(*inputs, *args)
    assert torch.equal(zk, zp) and torch.equal(ihk, ihp)
    torch.testing.assert_close(ihk, ihp, rtol=2e-5, atol=1e-8)
    rows = P3._rows(cells)
    half_w2 = consts(args[1])[1]
    ek = P3.energy_c3(list(zk), rows, tuple(args[0]), list(dxpu), half_w2)[1]
    ep = P3.energy_c3(list(zp), rows, tuple(args[0]), list(dxpu), half_w2)[1]
    torch.testing.assert_close(ek, ep, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("test_type,mon_type", [("SquareGrid", 1), ("Shoulder", 0)])
def test_k4_matches_plain(test_type, mon_type):
    _card()
    _, integ = _problem3(test_type, mon_type)
    inputs, args = _inputs(integ)
    before = P3.prox3d.launches
    zk, ihk = P3.prox3d(*inputs, *args)
    torch.cuda.synchronize()
    assert P3.prox3d.launches == before + 1
    _check_pair3(inputs, args, zk, ihk)


@pytest.mark.parametrize("n", [1, 127, 129, 700])
def test_k4_ragged_sizes(n):
    _card()
    _, integ = _problem3()
    inputs, args = _inputs(integ)
    cut = tuple(t[:, :n].contiguous() for t in inputs)
    zk, ihk = P3.prox3d(*cut, *args)
    torch.cuda.synchronize()
    _check_pair3(cut, args, zk, ihk)


def test_3d_path_launches_k4_once_per_admm_iteration():
    _card()
    _, integ = _problem3("Shoulder", 0)
    P3.prox3d.launches = P.prox2d.launches = 0
    iters = []
    _, trace, steps = run(integ, integ.init_state(), cap=3, dt_tol=0.0,
                          on_step=lambda k, info: iters.append(info.n_iters))
    assert P3.prox3d.launches == sum(iters) > 0 and P.prox2d.launches == 0
    assert trace[steps - 1] < trace[0]


def test_cuda_tensors_never_take_the_plain_k4():
    """A CUDA input of the wrong shape, type or device raises; there is no
    fallback."""
    _card()
    _, integ = _problem3()
    (z, dxpu, free, cells), args = _inputs(integ)
    with pytest.raises(ValueError):
        P3.prox3d(z.double(), dxpu, free, cells, *args)
    with pytest.raises(ValueError):
        P3.prox3d(z, dxpu, free, cells[:200].contiguous(), *args)
    with pytest.raises(ValueError):
        P3.prox3d(z, dxpu.cpu(), free, cells, *args)


def _stock(dim=3, nx=4):
    """The stock engine: 3D CompSquare (a computational mesh, K4') or 2D
    SquareGrid nx=8 (off the stencil gate, K1 behind its element-major
    entry)."""
    if dim == 3:
        cfg = ExperimentConfig(test_type="SquareGrid", dim=3, mon_type=5, method=0,
                               comp_mesh=True, nx=nx, ny=nx, nz=nx, rho=10.0, dtype="float32")
    else:
        cfg = ExperimentConfig(test_type="SquareGrid", dim=2, mon_type=5, method=0, nx=8, ny=8,
                               dt=0.05, rho=5.0, admm_iter=100, dtype="float32")
    return build_problem(cfg)


def _stock_inputs(integ):
    """The stock engine's first prox call of step 0 as channel tensors, and
    the element-major blocks it came from."""
    from mmadmm_tpu_torch.ops.monitor_grid import element_cell_rows

    _, x, z, u = integ.start(integ.init_state())
    dxpu = integ.gather(x) + u
    nf = z.shape[0]

    def ch(a):
        return a.reshape(nf, -1).T.contiguous()

    chans = (ch(z), ch(dxpu), ch(integ.free), element_cell_rows(integ.mesh.grid, z))
    if integ.mesh.comp_mesh:
        chans += (ch(integ.mesh.elem_ehat),)
    return chans, (z, dxpu)


def _check_pair4c(inputs, args, zk, ihk):
    """K4' against its plain version: bit for bit, and within the bands of
    tests/test_torch_prox3d_chord.py."""
    z, dxpu, free, cells, eh = inputs
    zp, ihp = P3.prox3d_chord_comp_plain(*inputs, *args)
    assert torch.equal(zk, zp) and torch.equal(ihk, ihp)
    torch.testing.assert_close(ihk, ihp, rtol=2e-5, atol=1e-8)
    rows = P3._rows(cells)
    half_w2 = consts(args[0])[1]
    ek = P3.energy_c3(list(zk), rows, list(eh), list(dxpu), half_w2)[1]
    ep = P3.energy_c3(list(zp), rows, list(eh), list(dxpu), half_w2)[1]
    torch.testing.assert_close(ek, ep, rtol=1e-4, atol=1e-6)


def test_k4c_matches_plain():
    _card()
    _, integ = _stock()
    inputs, _ = _stock_inputs(integ)
    args = (integ.w, integ.prox_tol, integ.prox_max_iters)
    before = P3.prox3d_chord_comp.launches
    zk, ihk = P3.prox3d_chord_comp(*inputs, *args)
    torch.cuda.synchronize()
    assert P3.prox3d_chord_comp.launches == before + 1
    _check_pair4c(inputs, args, zk, ihk)


@pytest.mark.parametrize("n", [1, 127, 129, 700])
def test_k4c_ragged_sizes(n):
    _card()
    _, integ = _stock()
    inputs, _ = _stock_inputs(integ)
    args = (integ.w, integ.prox_tol, integ.prox_max_iters)
    cut = tuple(t[:, :n].contiguous() for t in inputs)
    zk, ihk = P3.prox3d_chord_comp(*cut, *args)
    torch.cuda.synchronize()
    _check_pair4c(cut, args, zk, ihk)


def test_k1_element_entry_matches_plain():
    """K1 behind the stock engine's element-major entry: the entry equals
    the channel call, which is within K1's bands of its plain version."""
    _card()
    _, integ = _stock(dim=2)
    inputs, (z, dxpu) = _stock_inputs(integ)
    args = (integ.mesh.ehat_np.reshape(-1), integ.w, integ.prox_tol, integ.prox_max_iters)
    ze, ihe = P.prox_elements(integ.mesh.grid, z, dxpu, integ.free, *args)
    zk, ihk = P.prox2d(*inputs, *args)
    torch.cuda.synchronize()
    assert torch.equal(ze, zk.T.reshape(-1, 3, 2)) and torch.equal(ihe, ihk)
    _check_pair(inputs, args, zk, ihk)


@pytest.mark.parametrize("dim", [2, 3])
def test_stock_paths_launch_their_kernel_once_per_admm_iteration(dim):
    _card()
    _, integ = _stock(dim)
    for fn in (P.prox2d, P3.prox3d, P3.prox3d_chord_comp):
        fn.launches = 0
    iters = []
    _, trace, steps = run(integ, integ.init_state(), cap=3, dt_tol=0.0,
                          on_step=lambda k, info: iters.append(info.n_iters))
    want = {2: (sum(iters), 0, 0), 3: (0, 0, sum(iters))}[dim]
    assert (P.prox2d.launches, P3.prox3d.launches, P3.prox3d_chord_comp.launches) == want
    assert sum(iters) > 0 and trace[steps - 1] < trace[0]


def test_cuda_tensors_never_take_the_plain_k4c():
    """A CUDA input of the wrong shape, type or device raises; there is no
    fallback."""
    _card()
    _, integ = _stock()
    (z, dxpu, free, cells, eh), _ = _stock_inputs(integ)
    args = (integ.w, integ.prox_tol, integ.prox_max_iters)
    with pytest.raises(ValueError):
        P3.prox3d_chord_comp(z.double(), dxpu, free, cells, eh, *args)
    with pytest.raises(ValueError):
        P3.prox3d_chord_comp(z, dxpu, free, cells, eh[:6].contiguous(), *args)
    with pytest.raises(ValueError):
        P3.prox3d_chord_comp(z, dxpu, free, cells, eh.cpu(), *args)


# K4''a (``prox3d_chord``, 3D SquareGrid with prox_chord=True) and K4''b
# (``prox3d_comp``, 3D CompSquare with prox_chord=False), both on the stock
# engine: bit-equal to their plain versions, as K4 and K4' are.
K4PP = {
    "chord": (lambda: P3.prox3d_chord, lambda: P3.prox3d_chord_plain,
              dict(mon_type=1, rho=50.0), True),
    "comp": (lambda: P3.prox3d_comp, lambda: P3.prox3d_comp_plain,
             dict(mon_type=5, rho=10.0, comp_mesh=True), False),
}


def _k4pp(variant, nx=4):
    """``(integrator, kernel, plain, channel inputs, args)`` of a K4''
    variant on its stock-engine path."""
    kernel, plain, kw, chord = K4PP[variant]
    cfg = ExperimentConfig(test_type="SquareGrid", dim=3, method=0, nx=nx, ny=nx, nz=nx,
                           dtype="float32", **kw)
    _, integ = build_problem(cfg, prox_chord=chord)
    inputs, _ = _stock_inputs(integ)
    args = (integ.w, integ.prox_tol, integ.prox_max_iters)
    if not integ.mesh.comp_mesh:
        args = (integ.mesh.ehat_np.reshape(-1),) + args
    return integ, kernel(), plain(), inputs, args


@pytest.mark.parametrize("variant", list(K4PP))
def test_k4pp_bit_equal_to_plain(variant):
    _card()
    _, kernel, plain, inputs, args = _k4pp(variant)
    before = kernel.launches
    zk, ihk = kernel(*inputs, *args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    zp, ihp = plain(*inputs, *args)
    assert torch.equal(zk, zp) and torch.equal(ihk, ihp)


@pytest.mark.parametrize("n", [1, 127, 129, 700])
@pytest.mark.parametrize("variant", list(K4PP))
def test_k4pp_ragged_sizes(variant, n):
    _card()
    _, kernel, plain, inputs, args = _k4pp(variant)
    cut = tuple(t[:, :n].contiguous() for t in inputs)
    zk, ihk = kernel(*cut, *args)
    torch.cuda.synchronize()
    zp, ihp = plain(*cut, *args)
    assert torch.equal(zk, zp) and torch.equal(ihk, ihp)


@pytest.mark.parametrize("variant", list(K4PP))
def test_k4pp_paths_launch_once_per_admm_iteration(variant):
    _card()
    integ, kernel, *_ = _k4pp(variant)
    others = [P.prox2d, P3.prox3d, P3.prox3d_chord_comp, P3.prox3d_chord, P3.prox3d_comp]
    for fn in others:
        fn.launches = 0
    iters = []
    _, trace, steps = run(integ, integ.init_state(), cap=3, dt_tol=0.0,
                          on_step=lambda k, info: iters.append(info.n_iters))
    assert kernel.launches == sum(iters) > 0
    assert all(fn.launches == 0 for fn in others if fn is not kernel)
    assert trace[steps - 1] < trace[0]


@pytest.mark.parametrize("variant", list(K4PP))
def test_cuda_tensors_never_take_the_plain_k4pp(variant):
    """A CUDA input of the wrong shape, type or device raises; there is no
    fallback."""
    _card()
    _, kernel, _, (z, dxpu, free, cells, *eh), args = _k4pp(variant)
    with pytest.raises(ValueError):
        kernel(z.double(), dxpu, free, cells, *eh, *args)
    with pytest.raises(ValueError):
        kernel(z, dxpu, free, cells[:200].contiguous(), *eh, *args)
    with pytest.raises(ValueError):
        kernel(z, dxpu.cpu(), free, cells, *eh, *args)


# The Newton kernels K4 (``prox3d``, 3D Shoulder nx=4, a constant grid) and
# K4''b (``prox3d_comp``, 3D CompSquare nx=4), where a group of lanes shares
# an element, bit for bit against their plain versions: as the path calls
# them, with at most 1 and 2 sweeps, at ragged sizes (below one block, not a
# multiple of 4, not a multiple of a block's elements) and with an element
# whose Hessian is not finite. That element's monitor is scaled by 1e-9, so
# the determinant of its summed monitor squares to below the smallest f32:
# the dual pass's 1/det^2 is inf, the solve is not finite and the step is
# -g/w^2; at w = 1000 that step is accepted, so the element moves on it.
NEWTON_CASES = ["path", "max_iters=1", "max_iters=2", "fallback", "n=1", "n=5", "n=127",
                "n=129", "n=700"]


def _newton(variant):
    """``(kernel, plain, channel inputs, args)`` of K4 or K4''b at nx=4."""
    if variant == "K4":
        _, integ = _problem3("Shoulder", 0)
        inputs, args = _inputs(integ)
        return P3.prox3d, P3.prox3d_plain, inputs, list(args)
    _, kernel, plain, inputs, args = _k4pp("comp")
    return kernel, plain, inputs, list(args)


@pytest.mark.parametrize("case", NEWTON_CASES)
@pytest.mark.parametrize("variant", ["K4", "K4''b"])
def test_newton_kernels_bit_equal_to_plain(variant, case, monkeypatch):
    _card()
    from mmadmm_tpu_torch.ops import newton as N

    kernel, plain, inputs, args = _newton(variant)
    if case.startswith("max_iters="):
        args[-1] = int(case.split("=")[1])
    elif case.startswith("n="):
        inputs = tuple(t[:, :int(case[2:])].contiguous() for t in inputs)
    elif case == "fallback":
        live = int(torch.nonzero(inputs[2].sum(0) > 0)[0])
        cells = inputs[3].clone()
        for v in range(4):
            cells[v * 54:v * 54 + 48, live] *= 1e-9
        inputs = (*inputs[:3], cells, *inputs[4:])
        args[-3] = 1000.0
    before = kernel.launches
    zk, ihk = kernel(*inputs, *args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    fallbacks = []
    solve = N._solve

    def spy(H, g, inv_w2):
        p = N.ldlt_c(H, [-gi for gi in g])
        bad = ~torch.stack([torch.isfinite(pi) for pi in p]).all(0)
        fallbacks.append(int((bad & torch.stack([torch.isfinite(gi) for gi in g]).all(0)).sum()))
        return solve(H, g, inv_w2)

    monkeypatch.setattr(N, "_solve", spy)
    zp, ihp = plain(*inputs, *args)
    assert torch.equal(zk, zp) and torch.equal(ihk, ihp)
    if case == "fallback":
        assert sum(fallbacks) >= 1 and not torch.equal(zp[:, live], inputs[0][:, live])


# The chord kernels K4' (``prox3d_chord_comp``, 3D CompSquare nx=4) and K4''a
# (``prox3d_chord``, 3D SquareGrid nx=4 with prox_chord=True), where a group
# of lanes shares an element and its cached factors, bit for bit against
# their plain versions: as the path calls them, with at most 1 and 2 sweeps,
# with the fallback element of NEWTON_CASES (its entry Hessian is not
# finite, so its cached step is -g/w^2), at ragged sizes, and on one block
# of 32 elements whose duals are perturbed by a seeded normal so that some
# elements refresh their cache while their neighbours keep it (the plain
# version's Hessian builds after the entry ones show it).
CHORD_CASES = ["path", "max_iters=1", "max_iters=2", "fallback", "mixed refresh", "n=1", "n=5",
               "n=127", "n=129", "n=700"]


def _chord(variant):
    """``(kernel, plain, channel inputs, args)`` of K4' or K4''a at nx=4."""
    if variant == "K4'":
        _, integ = _stock()
        inputs, _ = _stock_inputs(integ)
        return (P3.prox3d_chord_comp, P3.prox3d_chord_comp_plain, inputs,
                [integ.w, integ.prox_tol, integ.prox_max_iters])
    _, kernel, plain, inputs, args = _k4pp("chord")
    return kernel, plain, inputs, list(args)


@pytest.mark.parametrize("case", CHORD_CASES)
@pytest.mark.parametrize("variant", ["K4'", "K4''a"])
def test_chord_kernels_bit_equal_to_plain(variant, case, monkeypatch):
    _card()
    import numpy as np

    from mmadmm_tpu_torch.ops import newton as N

    kernel, plain, inputs, args = _chord(variant)
    if case.startswith("max_iters="):
        args[-1] = int(case.split("=")[1])
    elif case.startswith("n="):
        inputs = tuple(t[:, :int(case[2:])].contiguous() for t in inputs)
    elif case == "mixed refresh":
        noise = np.random.default_rng(0).normal(scale=3e-3, size=tuple(inputs[1].shape))
        dxpu = inputs[1] + torch.tensor(noise, dtype=torch.float32, device=inputs[1].device)
        inputs = tuple(t[:, :32].contiguous() for t in (inputs[0], dxpu, *inputs[2:]))
    elif case == "fallback":
        live = int(torch.nonzero(inputs[2].sum(0) > 0)[0])
        cells = inputs[3].clone()
        for v in range(4):
            cells[v * 54:v * 54 + 48, live] *= 1e-9
        inputs = (*inputs[:3], cells, *inputs[4:])
        args[-3] = 1000.0
    before = kernel.launches
    zk, ihk = kernel(*inputs, *args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    fallbacks, built = [], []
    solve, hess = N._solve, P3.hess_c3

    def spy(H, g, inv_w2):
        p = N.ldlt_c(H, [-gi for gi in g])
        bad = ~torch.stack([torch.isfinite(pi) for pi in p]).all(0)
        fallbacks.append(int((bad & torch.stack([torch.isfinite(gi) for gi in g]).all(0)).sum()))
        return solve(H, g, inv_w2)

    def counted(z, *rest):
        built.append(z[0].shape[0])
        return hess(z, *rest)

    monkeypatch.setattr(N, "_solve", spy)
    monkeypatch.setattr(P3, "hess_c3", counted)
    stats = {}
    zp, ihp = plain(*inputs, *args, stats=stats)
    assert torch.equal(zk, zp) and torch.equal(ihk, ihp)
    if case == "fallback":
        assert sum(fallbacks) >= 1 and not torch.equal(zp[:, live], inputs[0][:, live])
    if case == "mixed refresh":
        assert stats["refreshes"] >= 1 and built[0] == 32
        assert len(built) > 1 and all(0 < k < 32 for k in built[1:])


# The float64 builds of K1, K2, K3 and K4 (``mm_prox2d_f64``, ``mm_eg2d_f64``,
# ``mm_hess2d_f64``, ``mm_prox3d_f64``), bit for bit against their plain
# versions in float64, on the float64 stencil engines' inputs at nx=16 (2D)
# and nx=4 (3D), at ragged sizes, and the float64 paths' launches, counted
# apart from the float32 ones.
def _problem64(dim=2, method=0, test_type="Shoulder", mon_type=1):
    kw = dict(test_type=test_type, dim=dim, mon_type=mon_type, method=method, nx=16, ny=16,
              dtype="float64")
    if dim == 3:
        kw.update(nx=4, ny=4, nz=4)
    return build_problem(ExperimentConfig(**kw))


F64_CASES = ["path", "max_iters=1", "n=1", "n=5", "n=127", "n=129", "n=700"]


def _cut(inputs, args, case):
    args = list(args)
    if case.startswith("max_iters="):
        args[-1] = int(case.split("=")[1])
    elif case.startswith("n="):
        inputs = tuple(t[:, :int(case[2:])].contiguous() for t in inputs)
    return inputs, args


@pytest.mark.parametrize("case", F64_CASES)
def test_k1_f64_bit_equal_to_plain(case):
    _card()
    _, integ = _problem64()
    inputs, args = _cut(*_inputs(integ), case)
    assert inputs[0].dtype == torch.float64
    before = (P.prox2d.launches, P.prox2d.launches_f64)
    zk, ihk = P.prox2d(*inputs, *args)
    torch.cuda.synchronize()
    assert (P.prox2d.launches, P.prox2d.launches_f64) == (before[0], before[1] + 1)
    zp, ihp = P.prox2d_plain(*inputs, *args)
    assert zk.dtype == torch.float64 and torch.equal(zk, zp) and torch.equal(ihk, ihp)


# K1's block edges in both builds, bit for bit against the plain version, on
# Shoulder nx=48's step-0 inputs (9,216 slots, 2,304 of them carved): a
# block of E elements (E from the built library: its stage, one thread an
# element) cut 1, E - 1 and E + 1 columns in, 4,001 columns (a multiple of
# no E), one block of carved slots only (free all 0, each taking one whole
# sweep), and at most 1 sweep.
K1_EDGES = ["n=1", "n=E-1", "n=E+1", "n=4001", "carved block", "max_iters=1"]


@pytest.mark.parametrize("case", K1_EDGES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k1_block_edges_bit_equal_to_plain(dtype, case):
    _card()
    _, integ = build_problem(ExperimentConfig(
        test_type="Shoulder", dim=2, mon_type=1, nx=48, ny=48, dtype=dtype))
    inputs, args = _inputs(integ)
    args = list(args)
    e = P.block_shape(inputs[0].dtype)[0]
    if case == "max_iters=1":
        args[-1] = 1
    elif case == "carved block":
        cols = torch.nonzero(inputs[2].sum(0) == 0)[:, 0]
        assert cols.numel() >= e
        inputs = tuple(t[:, cols[:e]].contiguous() for t in inputs)
    else:
        m = {"n=1": 1, "n=E-1": e - 1, "n=E+1": e + 1, "n=4001": 4001}[case]
        inputs = tuple(t[:, :m].contiguous() for t in inputs)
    before = (P.prox2d.launches, P.prox2d.launches_f64)
    zk, ihk = P.prox2d(*inputs, *args)
    torch.cuda.synchronize()
    f64 = dtype == "float64"
    assert (P.prox2d.launches, P.prox2d.launches_f64) == (before[0] + (not f64),
                                                          before[1] + f64)
    zp, ihp = P.prox2d_plain(*inputs, *args)
    assert zk.dtype == inputs[0].dtype and torch.equal(zk, zp) and torch.equal(ihk, ihp)


@pytest.mark.parametrize("n", [None, 1, 127, 129, 1000])
def test_k2_k3_f64_bit_equal_to_plain(n):
    _card()
    _, integ = _problem64(method=2)
    z = integ.eg.gather(integ.mesh.X0).contiguous()
    cells, ehat = integ.eg.cells(z), integ.mesh.ehat_np.reshape(-1)
    if n is not None:
        z, cells = z[:, :n].contiguous(), cells[:, :n].contiguous()
    before = (B.eg2d.launches_f64, B.hess2d.launches_f64)
    gk, ihk = B.eg2d(z, cells, ehat)
    Hk = B.hess2d(z, cells, ehat)
    torch.cuda.synchronize()
    assert (B.eg2d.launches_f64, B.hess2d.launches_f64) == (before[0] + 1, before[1] + 1)
    gp, ihp = B.eg2d_plain(z, cells, ehat)
    assert gk.dtype == torch.float64
    assert torch.equal(gk, gp) and torch.equal(ihk, ihp)
    assert torch.equal(Hk, B.hess2d_plain(z, cells, ehat))


@pytest.mark.parametrize("case", F64_CASES)
@pytest.mark.parametrize("test_type,mon_type", [("SquareGrid", 1), ("Shoulder", 0)])
def test_k4_f64_bit_equal_to_plain(test_type, mon_type, case):
    _card()
    _, integ = _problem64(3, 0, test_type, mon_type)
    inputs, args = _cut(*_inputs(integ), case)
    assert inputs[0].dtype == torch.float64
    before = (P3.prox3d.launches, P3.prox3d.launches_f64)
    zk, ihk = P3.prox3d(*inputs, *args)
    torch.cuda.synchronize()
    assert (P3.prox3d.launches, P3.prox3d.launches_f64) == (before[0], before[1] + 1)
    zp, ihp = P3.prox3d_plain(*inputs, *args)
    assert zk.dtype == torch.float64 and torch.equal(zk, zp) and torch.equal(ihk, ihp)


@pytest.mark.parametrize("dim,method", [(2, 0), (2, 1), (2, 2), (3, 0)],
                         ids=["admm", "euler", "be", "admm3d"])
def test_float64_paths_launch_the_float64_kernels(dim, method):
    """K1 or K4 once per ADMM iteration, K2 once per Euler step, K2 and K3
    as backward Euler counts them: all in their float64 counters, the
    float32 counters at 0."""
    _card()
    _, integ = _problem64(dim, method)
    fns = (P.prox2d, B.eg2d, B.hess2d, P3.prox3d)
    for fn in fns:
        fn.launches = fn.launches_f64 = 0
    infos = []
    _, trace, steps = run(integ, integ.init_state(), cap=3, dt_tol=0.0,
                          on_step=lambda k, info: infos.append(info))
    assert steps == 3 and trace[2] < trace[0]
    assert all(fn.launches == 0 for fn in fns)
    got = tuple(fn.launches_f64 for fn in fns)
    if method == 0:
        iters = sum(i.n_iters for i in infos)
        assert got == ((iters, 0, 0, 0) if dim == 2 else (0, 0, 0, iters)) and iters > 0
    elif method == 1:
        assert got == (0, 3, 0, 0)
    else:
        assert got == (0, sum(i.n_newton for i in infos) + 3 * 3, 3, 0)


def test_float64_kernels_never_cast():
    """Mixed float32 and float64 inputs raise, for every 3D variant too (a
    float32 ``free``, or a float32 Ehat beside float64 channels), and
    launch nothing."""
    _card()
    _, integ = _problem64(3)
    (z, dxpu, free, cells), args = _inputs(integ)
    with pytest.raises(ValueError):
        P3.prox3d(z, dxpu.float(), free, cells, *args)
    _, integ2 = _problem64()
    (z2, dxpu2, free2, cells2), args2 = _inputs(integ2)
    with pytest.raises(ValueError):
        P.prox2d(z2, dxpu2, free2.float(), cells2, *args2)
    for variant in K4_64:
        _, kernel, _, (z3, d3, f3, c3, *eh), args3 = _k4_64(variant)
        before = (kernel.launches, kernel.launches_f64)
        with pytest.raises(ValueError):
            kernel(z3, d3, f3.float(), c3, *eh, *args3)
        if eh:
            with pytest.raises(ValueError):
                kernel(z3, d3, f3, c3, eh[0].float(), *args3)
        assert (kernel.launches, kernel.launches_f64) == before


# The float64 builds of K4', K4''a and K4''b (``mm_prox3d_chord_comp_f64``,
# ``mm_prox3d_chord_f64``, ``mm_prox3d_comp_f64``) on the stock engine's
# float64 inputs at nx=4 (3D CompSquare for K4' and K4''b, 3D SquareGrid
# with prox_chord=True for K4''a): bit for bit against their plain versions
# in float64, at ragged sizes, each launch counted in ``launches_f64``, and
# their float64 paths launching them once per ADMM iteration.
K4_64 = {
    "K4'": (lambda: P3.prox3d_chord_comp, lambda: P3.prox3d_chord_comp_plain,
            dict(mon_type=5, rho=10.0, comp_mesh=True), None),
    "K4''a": (lambda: P3.prox3d_chord, lambda: P3.prox3d_chord_plain,
              dict(mon_type=1, rho=50.0), True),
    "K4''b": (lambda: P3.prox3d_comp, lambda: P3.prox3d_comp_plain,
              dict(mon_type=5, rho=10.0, comp_mesh=True), False),
}


def _k4_64(variant, nx=4):
    """``(integrator, kernel, plain, channel inputs, args)`` of a float64
    3D variant on its stock-engine path (``prox_backend="pallas"``)."""
    kernel, plain, kw, chord = K4_64[variant]
    cfg = ExperimentConfig(test_type="SquareGrid", dim=3, method=0, nx=nx, ny=nx, nz=nx,
                           dtype="float64", prox_backend="pallas", **kw)
    _, integ = build_problem(cfg, prox_chord=chord)
    inputs, _ = _stock_inputs(integ)
    args = (integ.w, integ.prox_tol, integ.prox_max_iters)
    if not integ.mesh.comp_mesh:
        args = (integ.mesh.ehat_np.reshape(-1),) + args
    return integ, kernel(), plain(), inputs, args


@pytest.mark.parametrize("case", F64_CASES)
@pytest.mark.parametrize("variant", list(K4_64))
def test_k4c_k4pp_f64_bit_equal_to_plain(variant, case):
    _card()
    _, kernel, plain, inputs, args = _k4_64(variant)
    inputs, args = _cut(inputs, args, case)
    assert inputs[0].dtype == torch.float64
    before = (kernel.launches, kernel.launches_f64)
    zk, ihk = kernel(*inputs, *args)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.launches_f64) == (before[0], before[1] + 1)
    zp, ihp = plain(*inputs, *args)
    assert zk.dtype == torch.float64 and torch.equal(zk, zp) and torch.equal(ihk, ihp)


@pytest.mark.parametrize("variant", list(K4_64))
def test_float64_stock_paths_launch_their_float64_kernel(variant):
    _card()
    integ, kernel, *_ = _k4_64(variant)
    fns = (P.prox2d, P3.prox3d, P3.prox3d_chord_comp, P3.prox3d_chord, P3.prox3d_comp)
    for fn in fns:
        fn.launches = fn.launches_f64 = 0
    iters = []
    _, trace, steps = run(integ, integ.init_state(), cap=3, dt_tol=0.0,
                          on_step=lambda k, info: iters.append(info.n_iters))
    assert kernel.launches_f64 == sum(iters) > 0
    assert all(fn.launches == 0 for fn in fns)
    assert all(fn.launches_f64 == 0 for fn in fns if fn is not kernel)
    assert trace[steps - 1] < trace[0]
