"""The import guard: names compared by their whole top-level name, the
harness loading neither JAX nor the JAX package, and the reference
importing nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import guard
from benchmark.cells import HERE, ROOT


def test_top_level_names_compared_whole():
    mods = ["mmadmm_tpu_torch", "mmadmm_tpu_torch.ops", "torch", "jaxtyping", "flaxen"]
    assert guard.forbidden(mods) == []
    assert guard.forbidden(mods + ["jax._src.core", "mmadmm_tpu.ops"]) == ["jax", "mmadmm_tpu"]
    assert guard.forbidden(["jaxlib", "flax.linen"]) == ["flax", "jaxlib"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    n = 0
    for d, _, files in os.walk(os.path.join(HERE, "reference")):
        for f in sorted(files):
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(os.path.join(d, f))}
                assert not tops & {"mmadmm_tpu_torch", "mmadmm_tpu", "jax", "benchmark"}, f
                n += 1
    assert n >= 12


def test_harness_loads_no_jax():
    """Importing every module of the harness and its reference, and
    building the reference of a configuration, loads neither JAX nor the
    JAX package, and the reference alone loads nothing of the program."""
    code = (
        "import sys, json\n"
        "from benchmark.reference import geometry, steps\n"
        "cfg = json.load(open('benchmark/configs/3DMonitor280.json'))\n"
        "cfg.update(nx=2, ny=2, nz=2)\n"
        "for name in ('admm', 'euler'):\n"
        "    steps.load(name).build(cfg, geometry.geometry(cfg))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'mmadmm_tpu_torch'}))\n"
        "import benchmark.run, benchmark.control\n"
        "from benchmark import guard\n"
        "print(guard.forbidden())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[]", "[]"]
