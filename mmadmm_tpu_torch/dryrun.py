"""Multi-rank dry run: the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:49-125``).

    python -m mmadmm_tpu_torch.dryrun <n> [--device cpu] [--backend gloo|nccl]

runs the same small problem (2D SquareGrid nx=22 in float64, MonType 1:
1,936 elements, so 3 ranks pad the element batch, and an RCB split with a
shared cut) on one device, on ``n`` ranks and on 3 ranks (when ``n > 3``),
three MM-ADMM steps each, and one step each of explicit and backward Euler
on one device and on ``n`` ranks. It checks that every sharded ``I_h``
trace stays within 1e-9 (relative, against max(1, |I_h|)) of the
one-device trace with the same ADMM counts, and raises if not.
"""

from __future__ import annotations

import argparse

from .config import ExperimentConfig
from .problems import build_problem

NX = 22
N_STEPS = 3
RTOL = 1e-9


def config(method: int = 0) -> ExperimentConfig:
    return ExperimentConfig(name="dryrun", test_type="SquareGrid", dim=2, mon_type=1,
                            method=method, nx=NX, ny=NX, dt=5e-3, tau=0.1, rho=50.0,
                            dtype="float64")


def trace(group, method: int, steps: int, device=None):
    """``(I_h trace, counts)`` of ``steps`` steps of ``method``, on one
    ``device`` (``group=None``) or on this rank of ``group``."""
    _, integ = build_problem(config(method), device, group=group)
    state, ihs, counts = integ.init_state(), [], []
    for _ in range(steps):
        state, info = integ.step(state)
        ihs.append(info.ih)
        counts.append(getattr(info, "n_iters", getattr(info, "n_newton", 0)))
    return ihs, counts


def rank_traces(group):
    """This rank's MM-ADMM trace and its Euler and backward-Euler steps."""
    return {0: trace(group, 0, N_STEPS), 1: trace(group, 1, 1), 2: trace(group, 2, 1)}


def _close(a, b) -> bool:
    return all(abs(x - y) <= RTOL * max(1.0, abs(x)) for x, y in zip(a, b))


def dryrun(n: int, device=None, backend=None, timeout_s: float = 900.0) -> dict:
    """Run the checks on ``n`` ranks and, when ``n > 3``, on 3; returns
    ``{ranks: {method: (I_h trace, counts)}}`` (``ranks`` 1 for the
    one-device runs)."""
    from .parallel.group import launch

    out = {1: {m: trace(None, m, N_STEPS if m == 0 else 1, device) for m in (0, 1, 2)}}
    for k in sorted({n} | ({3} if n > 3 else set())):
        out[k] = launch(rank_traces, k, backend=backend, device=device,
                        timeout_s=timeout_s)[0]
    for k, runs in out.items():
        for m, (ihs, counts) in runs.items():
            ihs1, counts1 = out[1][m]
            if not _close(ihs1, ihs):
                raise AssertionError(f"method {m} on {k} ranks: I_h {ihs} against {ihs1} on one")
            if counts != counts1:
                raise AssertionError(f"method {m} on {k} ranks: counts {counts} against {counts1}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    args = ap.parse_args(argv)
    out = dryrun(args.n, args.device, args.backend)
    ihs, counts = out[args.n][0]
    print(f"dryrun({args.n}): ok, the I_h traces on {sorted(out)} ranks agree with one device "
          f"(final I_h {ihs[-1]:.6f}, ADMM iterations {counts}; Euler I_h {out[args.n][1][0][0]:.6f}, "
          f"backward Euler I_h {out[args.n][2][0][0]:.6f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
