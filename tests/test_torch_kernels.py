"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card and ``nvcc`` and skips without
them; the file imports no JAX, so it also runs on the card's machine:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Bands for K1 (``csrc/prox2d.cu`` vs ``ops/prox2d.py::prox2d_plain``),
those of tests/test_prox_pallas2d.py:95-119: ih0 within rtol 2e-5, the
regularized energies after the solve within rtol 5e-5."""

import pytest
import torch

from mmadmm_tpu_torch import ExperimentConfig, build_problem
from mmadmm_tpu_torch.integrators.run_loop import run
from mmadmm_tpu_torch.ops import prox2d as P


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _problem(nx=16):
    return build_problem(ExperimentConfig(
        test_type="Shoulder", dim=2, mon_type=1, nx=nx, ny=nx, dtype="float32"))


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
