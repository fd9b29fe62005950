"""The benchmark of the PyTorch/CUDA port ``mmadmm_tpu_torch``: one cell
(a configuration under a traffic mix) a run, driven by ``BENCHMARK.json``
and the files named there. See ``benchmark/README.md``."""
