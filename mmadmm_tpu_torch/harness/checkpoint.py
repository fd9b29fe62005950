"""Checkpoint and resume (port of ``mmadmm_tpu/harness/checkpoint.py``).

The reference has no formal mechanism: its de facto path is writing the
final mesh as ``points.txt``/``triangles.txt`` and reading it back through
the ``FromFile`` test type (``main.cpp:814-831``, SURVEY §5.4). Here both
exist:

* ``save_checkpoint`` / ``load_checkpoint``: every field of the
  integrator's state (the stencil engines' and the stock engine's MM-ADMM
  state with its duals, the guard's carry and the stock engine's carried
  chord Jacobian ``J``; explicit and backward Euler's, with backward
  Euler's carried chord) and the config, as a compressed npz, so that a
  resumed run equals the uninterrupted one bit for bit;
* the reference-compatible CSV path through ``geometry.io`` and
  ``TestType: FromFile``.

The file's keys are the JAX package's where a field means the same thing
(``config``, ``x``, ``x_prev``, ``u_bar``, ``steps``, ``ih_last``,
``rose``, ``rises``, ``J``, ``step_i``, ``ih_prev``, ``F``, ``mask``);
``x`` and ``x_prev`` are node positions ``[NP, D]`` in float64 whatever
the engine's layout and dtype. The other fields keep their own names
(``j_fresh``; backward Euler's ``He``, ``dvec`` and ``rebuild``). Float
arrays are stored in float64, which holds float32 values exactly.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..integrators.admm_soa import SoA3DState

_KEY = {"u": "u_bar"}  # state field -> the JAX file's key for it


def _channel_major(state, name: str) -> bool:
    """Whether field ``name`` of ``state`` holds node positions
    channel-major (``[3, NP]``, the 3D stencil engine)."""
    return isinstance(state, SoA3DState) and name in ("x", "x_prev")


def save_checkpoint(
    ckpt_dir: str, cfg, mesh, state, step: int, ih_prev: float | None = None
) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:06d}.npz")
    tmp = path + ".tmp"
    arrays = {
        "F": np.asarray(mesh._F_np),
        "mask": np.asarray(mesh.mask_np),
        # outer-loop position and the DtTol comparator (main.cpp:200-208),
        # so a resumed run continues the convergence test exactly
        "step_i": np.asarray(step, dtype=np.int64),
        "ih_prev": np.asarray(float("inf") if ih_prev is None else ih_prev, dtype=np.float64),
    }
    for name, v in zip(state._fields, state):
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            a = (v.T if _channel_major(state, name) else v).detach().cpu().numpy()
            arrays[_KEY.get(name, name)] = a.astype(np.float64) if a.dtype.kind == "f" else a
        else:
            arrays[_KEY.get(name, name)] = np.asarray(v)
    with open(tmp, "wb") as f:
        np.savez_compressed(f, config=json.dumps(dataclasses.asdict(cfg)), **arrays)
    os.replace(tmp, path)  # atomic publish
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    files = sorted(
        f for f in os.listdir(ckpt_dir) if f.startswith("step_") and f.endswith(".npz")
    )
    return os.path.join(ckpt_dir, files[-1]) if files else None


def load_checkpoint(path: str):
    """Returns ``(cfg, arrays dict)``. Rebuild with ``resume_experiment``."""
    from ..config import ExperimentConfig

    with np.load(path, allow_pickle=False) as z:
        cfg = ExperimentConfig(**json.loads(str(z["config"])))
        arrays = {k: z[k] for k in z.files if k != "config"}
    return cfg, arrays


def resume_experiment(path: str, base_dir: str | None = None, device=None):
    """Rebuild ``(cfg, mesh, integrator, state)`` from a checkpoint file on
    ``device`` (the card unless the caller asks for the CPU); ``base_dir``
    overrides the config's root for FromFile paths. A tensor field whose
    saved shape differs from the fresh state's stays as ``init_state``
    makes it; an unrestored ``J`` is rebuilt at the next prox call."""
    from ..problems import build_problem

    cfg, arrays = load_checkpoint(path)
    if base_dir is not None:
        cfg = dataclasses.replace(cfg, base_dir=base_dir)
    mesh, integ = build_problem(cfg, device)
    state = integ.init_state()
    updates = {}
    for name, v in zip(state._fields, state):
        key = _KEY.get(name, name)
        if key not in arrays:
            continue
        a = arrays[key]
        if v is None or isinstance(v, torch.Tensor):
            dtype = mesh.dtype if v is None else v.dtype
            t = torch.as_tensor(a, dtype=dtype, device=mesh.device)
            if _channel_major(state, name):
                t = t.T.contiguous()
            if v is None or t.shape == v.shape:
                updates[name] = t
        else:
            updates[name] = type(v)(a.item())
    if "J" in state._fields and "J" not in updates:
        updates["j_fresh"] = True
    return cfg, mesh, integ, state._replace(**updates)


def checkpoint_meta(path: str) -> tuple[int, float]:
    """(outer step index, Ih comparator) recorded at save time; old
    checkpoints without them resume at step 0 with an inf comparator."""
    with np.load(path, allow_pickle=False) as z:
        step_i = int(z["step_i"]) if "step_i" in z.files else 0
        ih_prev = float(z["ih_prev"]) if "ih_prev" in z.files else float("inf")
    return step_i, ih_prev
