"""mmadmm_tpu_torch: the PyTorch/CUDA port of mmadmm_tpu (MM-ADMM moving
mesh adaptation).

The JAX package ``mmadmm_tpu`` is the reference; this package imports
neither JAX nor anything of it. Its entry points run on the CUDA card
unless the caller passes ``device="cpu"``. It runs on the 2D and 3D
stencil engines and the stock element-major engine, through
``problems.build_problem`` and ``integrators.run_loop.run``:

* MM-ADMM (method 0): ``integrators.admm_grid2d.GridADMM2D`` ->
  ``ops.prox2d.prox2d`` (kernel K1, ``csrc/prox2d.cu``); on the stencil
  engines each kernel is built in the mesh's dtype, float32 or float64;
* explicit Euler (method 1): ``integrators.euler.EulerIntegrator`` ->
  ``ops.be2d.eg2d`` (kernel K2, ``csrc/be2d.cu``) on the 2D stencil
  engine; on every other mesh the compact path ``ops.compact_eg`` (plain
  PyTorch, no kernel, as in the JAX package);
* backward Euler (method 2): ``integrators.backward_euler.
  BackwardEulerIntegrator`` -> K2 and ``ops.be2d.hess2d`` (kernel K3) on
  the 2D stencil engine with the ``neumann`` solve; ``ops.compact_eg`` and
  ``ops.krylov`` elsewhere and for the other inner solvers;
* 3D MM-ADMM (method 0 on 3D SquareGrid and Shoulder box meshes):
  ``integrators.admm_soa.SoAADMM3D`` -> ``ops.prox3d.prox3d`` (kernel K4,
  ``csrc/prox3d.cu``);
* MM-ADMM on every other mesh (FromFile, LevelSet, 2D off the stencil
  gate, computational meshes): ``integrators.admm.ADMMIntegrator`` ->
  ``ops.prox2d.prox_elements`` (K1) or ``ops.prox3d.prox_elements``
  (K4' on a computational mesh, ``csrc/prox3d.cu``; K4 otherwise) in
  float32, the generic prox (``ops/prox.py``) in float64 unless
  ``prox_backend="pallas"`` asks for K1 or K4 in float64;
* a run over several devices (``n_devices > 1``): ranks of
  ``torch.distributed`` (``parallel``), each on its shard of the elements,
  MM-ADMM on ``integrators.admm.ShardedADMMIntegrator`` (the same prox
  routes, on the rank's elements) and Euler and backward Euler on
  ``ops.compact_eg.ShardedEG``.
"""

from .config import ExperimentConfig, load_experiment_config
from .problems import build_problem

__all__ = ["ExperimentConfig", "load_experiment_config", "build_problem"]
