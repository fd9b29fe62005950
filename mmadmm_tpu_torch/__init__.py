"""mmadmm_tpu_torch: the PyTorch/CUDA port of mmadmm_tpu (MM-ADMM moving
mesh adaptation).

The JAX package ``mmadmm_tpu`` is the reference; this package imports
neither JAX nor anything of it. Its entry points run on the CUDA card
unless the caller passes ``device="cpu"``. The port's main path is
MM-ADMM (method 0) on the 2D stencil engine:
``problems.build_problem`` -> ``integrators.admm_grid2d.GridADMM2D`` ->
``ops.prox2d.prox2d`` (kernel K1, ``csrc/prox2d.cu``), driven by
``integrators.run_loop.run``.
"""

from .config import ExperimentConfig, load_experiment_config
from .problems import build_problem

__all__ = ["ExperimentConfig", "load_experiment_config", "build_problem"]
