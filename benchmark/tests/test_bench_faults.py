"""A run with the timed path broken underneath comes out as not correct:
for each fault a cell can have (one card, so no exchange between chips),
planted in the program at nx=4 on the CPU, the card's look skipped.

* ``unchanged``: a step returns the state it was given;
* ``half``: half of the elements left out and the rest counted double
  (the prox leaves the second half of its slots where they were; the
  Euler gradient is taken over the first half of the elements, doubled);
* ``altered``: one coordinate of a step's positions moved by 3e-5 of the
  grid spacing where the step produces them (ten times the widest limit
  on ``x_gap``).
"""

import pytest
import torch

from benchmark import inputs, run
from benchmark.tests._tiny import one_thread, tiny_cell


def plant(monkeypatch, cell, fault):
    from mmadmm_tpu_torch.harness.runner import positions
    from mmadmm_tpu_torch.integrators import admm_soa
    from mmadmm_tpu_torch.integrators.admm_soa import SoAADMM3D
    from mmadmm_tpu_torch.integrators.euler import EulerIntegrator
    from mmadmm_tpu_torch.ops.compact_eg import CompactEG

    cls = SoAADMM3D if cell.traffic["method"] == 0 else EulerIntegrator
    step = cls.step
    if fault == "unchanged":
        monkeypatch.setattr(cls, "step", lambda self, s: (s, step(self, s)[1]))
    elif fault == "altered":
        h = inputs.spacing(cell.cfg)

        def altered(self, s):
            new, info = step(self, s)
            x = new.x.clone()
            p = positions(new._replace(x=x))
            p[p.shape[0] // 2, 0] += 3e-5 * h
            return new._replace(x=x), info

        monkeypatch.setattr(cls, "step", altered)
    elif cell.traffic["method"] == 0:
        prox = admm_soa.prox3d

        def half(z, dxpu, free, cells, *args):
            zo, ih0 = prox(z, dxpu, free, cells, *args)
            n = z.shape[1] // 2
            zo, ih0 = zo.clone(), ih0.clone()
            zo[:, n:] = z[:, n:]
            ih0[n:] = ih0[:n].mean()
            return zo, ih0

        monkeypatch.setattr(admm_soa, "prox3d", half)
    else:
        def half_eg(self, x):
            mesh = self.mesh
            keep = torch.zeros(mesh.n_elements, 1, 1, dtype=x.dtype)
            keep[: mesh.n_elements // 2] = 2.0
            from mmadmm_tpu_torch.ops import huang
            from mmadmm_tpu_torch.ops.monitor_grid import gather_cell

            z = mesh.gather(x)
            ih_e, g_e = huang.element_energy_grad(z, gather_cell(mesh.grid, z), mesh.elem_ehat)
            ih = (ih_e * keep[:, 0, 0]).sum(dtype=torch.float64)
            return ih, mesh.scatter_add(g_e * keep) * mesh.interior_nodes

        monkeypatch.setattr(CompactEG, "__call__", half_eg)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", ["3DMonitor280.admm", "3DMonitor280.euler"])
def test_fault_is_not_correct(tmp_path, monkeypatch, name, fault):
    one_thread()
    cell = tiny_cell(tmp_path, name)
    plant(monkeypatch, cell, fault)
    result, compared = run.run_cell(cell, 2**31 + 3, 0.3, False, device="cpu")
    assert result["correct"] is False, compared
