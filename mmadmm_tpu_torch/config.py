"""Experiment configuration (port of ``mmadmm_tpu/config.py``).

Mirrors the reference's JSON experiment schema (``main.cpp:260-307``) plus
the framework's knobs (dtype, prox iteration cap, ADMM tolerance).

Reference quirks kept on purpose (see ``MovingMesh``):
  * the JSON ``w`` is ignored and overridden by ``w = 0.5*sqrt(rho)``
    (``src/Mesh.cpp:451``),
  * ``Method`` in the JSON is clobbered by the CLI argument
    (``main.cpp:809``).

``prox_backend`` (``MovingMesh`` decides it): ``"pallas"`` takes the
kernel route, the prox kernels K1, K4, K4' and K4'' (on the card; their
plain PyTorch versions on the CPU; in float64 K1 and K4 only), what the
JAX package's speed entry runs (``bench.py:182-193``); ``"vmap"`` the
generic batched prox (``ops/prox.py``) in any dtype, on the stock engine.
``"auto"`` (the default) takes the float32 kernels where one computes the
function and the generic prox elsewhere: every float64 run and every 2D
computational mesh. Box meshes on the stencil gate take their stencil
engine under ``"auto"`` and ``"pallas"`` in either dtype, with its
kernels in the mesh's dtype. ``dtype`` defaults to float64, as in the JAX
package, so a JSON config runs as loaded, as the JAX package's own
``"auto"`` runs it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass
class ExperimentConfig:
    # --- reference JSON schema (main.cpp:260-307) ---
    test_type: str = "SquareGrid"  # SquareGrid | LevelSet | Shoulder | FromFile
    dim: int = 2
    mon_type: int = 0
    method: int = 0  # 0 = MM-ADMM, 1 = explicit Euler, 2 = backward Euler
    comp_mesh: bool = False
    boundary_type: int = 1  # 0 = BOUNDARY_FREE, 1 = BOUNDARY_FIXED
    grad_use: bool = False
    n_steps: int = 100
    admm_iter: int = 10
    dt_tol: float = 1e-5
    dt: float = 5e-3
    tau: float = 0.1
    rho: float = 50.0
    w: float = 3.53553390593  # overridden by 0.5*sqrt(rho), kept for parity
    nx: int = 20
    ny: int = 20
    nz: int = 0
    xa: float = 0.0
    xb: float = 1.0
    ya: float = 0.0
    yb: float = 1.0
    za: float = 0.0
    zb: float = 1.0
    # FromFile mode (main.cpp:814-831)
    triangles_file: Optional[str] = None
    pnts_file: Optional[str] = None
    mask_file: Optional[str] = None

    # --- framework extensions (not in the reference schema) ---
    name: str = "experiment"
    base_dir: str = "."
    dtype: str = "float64"  # compute dtype; energy and residual sums are f64
    prox_newton_iters: int = 50  # reference BFGS cap (Mesh.cpp:968)
    prox_backend: str = "auto"  # "pallas": the kernels; "vmap": the generic prox
    step_tol: float = 1e-3  # ADMM primal/dual tol (main.cpp:184)
    n_devices: int = 1

    @property
    def boundary_node_type(self) -> int:
        from .geometry.node_type import NodeType

        return (
            NodeType.BOUNDARY_FREE if self.boundary_type == 0 else NodeType.BOUNDARY_FIXED
        )

    @classmethod
    def from_dict(
        cls, data: dict, name: str = "experiment", method: Optional[int] = None
    ) -> "ExperimentConfig":
        """Build from a reference-format JSON dict (``main.cpp:260-307``;
        ``from_reference_json`` in the JAX package)."""
        dim = int(data["Dim"])
        cfg = cls(
            name=name,
            test_type=str(data["TestType"]),
            dim=dim,
            mon_type=int(data["MonType"]),
            method=int(method if method is not None else data.get("Method", 0)),
            comp_mesh=bool(data["CompMesh"]),
            boundary_type=int(data["BoundaryType"]),
            grad_use=bool(data["GradUse"]),
            n_steps=int(data["nSteps"]),
            admm_iter=int(data["AdmmIter"]),
            dt_tol=float(data["DtTol"]),
            dt=float(data["dt"]),
            tau=float(data["tau"]),
            rho=float(data["rho"]),
            w=float(data.get("w", 0.0)),
            triangles_file=data.get("TrianglesFile"),
            pnts_file=data.get("PntsFile"),
            mask_file=data.get("MaskFile"),
        )
        if cfg.test_type != "FromFile":
            cfg.nx = int(data["nx"])
            cfg.ny = int(data["ny"])
            cfg.xa = float(data["xa"])
            cfg.xb = float(data["xb"])
            cfg.ya = float(data["ya"])
            cfg.yb = float(data["yb"])
            if dim == 3:
                cfg.nz = int(data["nz"])
                cfg.za = float(data["za"])
                cfg.zb = float(data["zb"])
        return cfg


def load_experiment_config(
    path: str, method: Optional[int] = None, name: Optional[str] = None
) -> ExperimentConfig:
    """Load a reference-format experiment JSON file."""
    with open(path) as f:
        data = json.load(f)
    if name is None:
        name = os.path.splitext(os.path.basename(path))[0]
    cfg = ExperimentConfig.from_dict(data, name=name, method=method)
    # FromFile paths are relative to the repo root the config lives in:
    # walk up from the config until a dir containing "Experiments" is found.
    d = os.path.dirname(os.path.abspath(path))
    while d != os.path.dirname(d):
        if os.path.isdir(os.path.join(d, "Experiments")):
            cfg.base_dir = d
            break
        d = os.path.dirname(d)
    return cfg
