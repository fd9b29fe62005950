"""The 3D slice end to end, shared by tests/test_torch_soa3d_shoulder.py and
tests/test_torch_soa3d_square.py: the port's SoAADMM3D against the JAX
package's SoAADMM3D in stencil mode (``MMADMM_SOA=1``, its Pallas kernel
in interpreter mode), both started from the same state through
``mmadmm_tpu_torch.convert``, over STEPS steps, so that step 3 takes the
extrapolation predictor.

Bands: ``n_iters`` identical at every step; the step energy within rel
2e-6, the band of the JAX package's SoA-vs-stock test (tests/test_soa.py);
the final node positions within 2e-6 absolute (O(1) positions, about 20
f32 ulps: the port sums in f64 where JAX adds f32 blocks, and XLA and
PyTorch order and fuse f32 operations differently).

The JAX engine compiles its interpreted 12x12 kernel inside the step
(about two minutes and 6 GB on a CPU), so each file runs its
configuration once, in a module-scoped fixture, under ``jax_compile_lock``
(shared with tests/test_torch_prox3d.py), and keeps only NumPy arrays of
the result."""

import atexit
import contextlib
import ctypes
import fcntl
import gc
import math
import os
import shutil
import tempfile
import time

import jax
import numpy as np
import pytest
import torch

from mmadmm_tpu.config import ExperimentConfig as JaxConfig
from mmadmm_tpu.problems import build_problem as jax_build_problem

from mmadmm_tpu_torch import ExperimentConfig, build_problem, convert
from mmadmm_tpu_torch.integrators.admm_soa import SoAADMM3D

STEPS = 4
X_ATOL = 2e-6
# compiles shorter than this are not shared (share_interpreted_compiles)
SHARED_COMPILE_SECS = 60.0


def share_interpreted_compiles():
    """JAX's persistent compilation cache, in a directory of this test run
    alone, shared by its pytest-xdist workers: an interpreted 3D kernel
    that two test files compile alike (tests/test_torch_prox3d_chord.py's
    K4' call is tests/test_prox_pallas3d.py's chord call on the same
    inputs) is compiled once, by the first, and loaded by the second. Only
    compiles of SHARED_COMPILE_SECS or more are written; the cache's size
    bound turns on its file lock, so no worker reads an entry half
    written. A loaded executable is the compiled one, bit for bit. Without
    xdist (one process) nothing is shared and the cache stays off.
    Returns the directory, or None.

    Called when this module is imported: every xdist worker imports every
    test module as it collects, before any test runs, so the workers that
    run the JAX package's own files share the cache too. The last worker
    to exit removes the directory."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not run:
        return None
    path = os.path.join(tempfile.gettempdir(), f"mmadmm_tpu_torch_jax_cache_{run}")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", SHARED_COMPILE_SECS)
    jax.config.update("jax_compilation_cache_max_size", 16 << 30)
    _count_users(path, 1)
    atexit.register(_leave_cache, path)
    return path


def _count_users(path, delta):
    """Add ``delta`` to the number of processes that use the cache at
    ``path`` (a file beside it, under a lock); returns the new number."""
    with open(path + ".users", "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        f.seek(0)
        n = int(f.read() or 0) + delta
        f.seek(0)
        f.truncate()
        f.write(str(n))
        f.flush()
    return n


def _leave_cache(path):
    """At a worker's exit: the last one out removes the run's cache."""
    if _count_users(path, -1) == 0:
        shutil.rmtree(path, ignore_errors=True)
        os.remove(path + ".users")


share_interpreted_compiles()


def config(test_type: str, mon_type: int, dtype: str = "float32") -> dict:
    return dict(test_type=test_type, dim=3, mon_type=mon_type, method=0, nx=4, ny=4, nz=4,
                dt=5e-3, tau=0.1, rho=50.0, dtype=dtype)


def release_jax_memory():
    """Hand the memory of JAX's compiled programs back to the system."""
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


# a second interpreted compile starts only while the machine has this much
# memory available: its own 6 GB, and room for the 15 GB chord compiles that
# run outside the lock
SECOND_COMPILE_GB = 24.0


def available_gb() -> float:
    """The memory the kernel reports available (MemAvailable), in GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return 0.0


@contextlib.contextmanager
def jax_compile_lock():
    """At most two interpreted JAX 3D kernel compiles at a time across the
    test processes (pytest-xdist workers), the second only while
    SECOND_COMPILE_GB are available, and each compile's memory handed back
    to the system afterwards: each holds about 6 GB. The five files that
    compile one (tests/test_torch_soa3d_*.py, tests/test_torch_f64_soa3d.py,
    tests/test_torch_prox3d.py, tests/test_torch_f64_prox3d.py) otherwise
    wait on each other in a chain that sets tier-1's critical path."""
    paths = [os.path.join(tempfile.gettempdir(), f"mmadmm_tpu_torch_jax3d{s}.lock")
             for s in ("", "_second")]
    while True:
        for slot, path in enumerate(paths):
            f = open(path, "w")
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except BlockingIOError:
                f.close()
                continue
            if slot and available_gb() < SECOND_COMPILE_GB:
                fcntl.flock(f, fcntl.LOCK_UN)
                f.close()
                continue
            try:
                yield
            finally:
                release_jax_memory()
                fcntl.flock(f, fcntl.LOCK_UN)
                f.close()
            return
        time.sleep(1.0)


def run_jax(kw: dict) -> dict:
    """The JAX SoA engine over STEPS steps, as NumPy: its constants
    ``consts``, ``ehat``, ``constant`` (grid), the start state ``x0,
    x_prev0, u0``, ``infos`` ``[(ih, n_iters)]`` and the final state
    ``x, steps, rises, rose``."""
    with jax_compile_lock():
        old = os.environ.get("MMADMM_SOA")
        os.environ["MMADMM_SOA"] = "1"
        try:
            jmesh, jinteg = jax_build_problem(JaxConfig(**kw))
        finally:
            if old is None:
                os.environ.pop("MMADMM_SOA", None)
            else:
                os.environ["MMADMM_SOA"] = old
        assert type(jinteg).__name__ == "SoAADMM3D" and jinteg.stencil
        s0 = jinteg.init_state()
        s, infos = s0, []
        for _ in range(STEPS):
            s, info = jinteg.step(s)
            infos.append((float(info.ih_start), int(info.n_iters)))
        c = jinteg._consts
        consts = {k: np.asarray(v) for k, v in c.items() if k != "axes"}
        consts["axes"] = [np.asarray(a) for a in c["axes"]]
        return dict(
            consts=consts, ehat=np.asarray(jmesh.ehat), constant=bool(jmesh.grid.constant),
            x0=np.asarray(s0.x), x_prev0=np.asarray(s0.x_prev), u0=np.asarray(s0.u),
            infos=infos, x=np.asarray(s.x), steps=int(s.steps), rises=int(s.rises),
            rose=bool(s.rose),
        )


def port_from_jax(kw: dict, j: dict):
    """The port's integrator and start state, loaded with the JAX engine's
    constants and state (``run_jax``'s result)."""
    _, integ = build_problem(ExperimentConfig(**kw), device="cpu")
    c = j["consts"]
    arrays = {k: c[k] for k in ("swap_t", "alive_t", "free_chunks", "valid", "t_node", "axes")}
    arrays["ehat"] = j["ehat"]
    if j["constant"]:
        arrays["sym6"] = c["sym6"]
    else:
        arrays["cell_table"] = c["cell_table"]
    convert.load_soa3d_consts(integ, arrays)
    state = convert.load_soa3d_state(integ, dict(x=j["x0"], x_prev=j["x_prev0"], u=j["u0"]))
    return integ, state


def run_port(integ, state):
    infos = []
    for _ in range(STEPS):
        state, info = integ.step(state)
        infos.append(info)
    return infos, state


def check_step(jax_infos, port_infos, k, rel=2e-6):
    ih_j, it_j = jax_infos[k]
    info = port_infos[k]
    assert info.n_iters == it_j
    assert info.ih == pytest.approx(ih_j, rel=rel)


def check_final_state(j, s_p, atol=X_ATOL):
    np.testing.assert_allclose(s_p.x.numpy(), j["x"], rtol=0, atol=atol)
    assert s_p.steps == j["steps"] and s_p.rises == j["rises"] and s_p.rose == j["rose"]


def check_energy_falls(integ, infos, state):
    ih = [i.ih for i in infos]
    assert all(math.isfinite(v) for v in ih) and ih[-1] < ih[0]
    assert torch.isfinite(state.x).all()
    assert integ.energy(state) < ih[0]


def check_round_trip(kw, j):
    """convert loads the JAX engine's state and constants unchanged, and
    the port's own set-up builds the same constants."""
    integ, state = port_from_jax(kw, j)
    np.testing.assert_array_equal(state.x.numpy(), j["x0"])
    np.testing.assert_array_equal(state.u.numpy(), np.zeros((12, integ.NFd)))
    assert state.steps == 0 and state.ih_last == math.inf
    _, own = build_problem(ExperimentConfig(**kw), device="cpu")
    assert isinstance(own, SoAADMM3D)
    for name in ("swap_t", "alive_t", "free", "valid", "t_node"):
        np.testing.assert_array_equal(getattr(own, name).numpy(), getattr(integ, name).numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(own.x0.numpy(), j["x0"])
    np.testing.assert_array_equal(own.mesh.ehat.numpy(), j["ehat"])
    grid = own.mesh.grid
    assert grid.constant == j["constant"]
    if grid.constant:
        np.testing.assert_array_equal(grid.sym6.numpy(), j["consts"]["sym6"])
    else:
        np.testing.assert_array_equal(grid.cell_table.numpy(), j["consts"]["cell_table"])
