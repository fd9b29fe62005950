"""Experiment harness: runner, checkpoints, sweeps, plots (port of
``mmadmm_tpu/harness``).

The counterpart of the reference's experiment layer (``runAlgo`` in
``main.cpp:142-255``, the ``experiments.py`` REPL workflows and
``plot.py``), writing artifacts in the reference's formats so that parity
checks are plain diffs. ``python -m mmadmm_tpu_torch.run`` is its CLI,
``python -m mmadmm_tpu_torch.harness`` its interactive menu.
"""

from .runner import RunResult, run_experiment

__all__ = ["RunResult", "run_experiment"]
