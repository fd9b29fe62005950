"""Rank groups over ``torch.distributed``: the port's counterpart of the
JAX package's ``make_device_mesh``, ``put_global`` and
``initialize_multihost`` (``mmadmm_tpu/parallel/spmd.py:52-106``).

One process a rank, each on its own device. The backend is explicit:

* ``nccl`` on CUDA, one card a rank (``LOCAL_RANK`` picks it);
* ``gloo`` on the CPU, or on CUDA when the caller names it (several ranks
  may then share a card: rank r takes card ``r % cards``).

More ranks than cards under NCCL raises, as does a CUDA run without a
card; nothing switches backend or device on its own. Every collective of
a step goes through ``RankGroup.all_reduce_sum``.

A group starts from the ``env://`` variables that ``torchrun`` sets
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, and
``LOCAL_RANK``), so several hosts run the same code; ``launch`` spawns
``n`` ranks on this host (start method ``spawn``) with a ``file://``
rendezvous, for the CLI, the sweeps and the tests.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..runtime.device import resolve_device

KERNEL_SOURCES = ("prox2d", "be2d", "prox3d")  # csrc/<name>.cu, built before ranks spawn
COLLECTIVE_TIMEOUT_S = 600.0  # a rank that waits longer in one collective fails the run


@dataclass
class RankGroup:
    rank: int
    size: int
    device: torch.device
    backend: str

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks; every rank gets the same bits."""
        if self.size == 1 or t.numel() == 0:
            return t
        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` stacked in rank order along dim 0 (checkpoints)."""
        if self.size == 1:
            return t
        if t.numel() == 0:
            return t.new_empty((self.size * t.shape[0], *t.shape[1:]))
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)


def plan(world_size: int, *, backend=None, device=None, local_rank: int = 0):
    """``(backend, device)`` for local rank ``local_rank`` of
    ``world_size`` ranks. ``device=None`` means CUDA; ``backend=None``
    means ``nccl`` on CUDA and ``gloo`` on the CPU. Raises where the pair
    cannot serve the ranks."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if dev.type != "cuda":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; use gloo on the CPU")
        return backend, dev
    cards = torch.cuda.device_count()
    if backend == "nccl" and local_rank >= cards:
        raise ValueError(
            f"nccl needs one card a rank: {world_size} ranks, {cards} card(s) on this host; "
            "name backend='gloo' to put several ranks on one card")
    index = dev.index if dev.index is not None else local_rank % cards
    return backend, torch.device("cuda", index)


def init_group(rank: int, world_size: int, *, backend=None, device=None,
               init_method: str = "env://", local_rank: int | None = None) -> RankGroup:
    """Join the default process group as ``rank`` of ``world_size``."""
    local = rank if local_rank is None else local_rank
    backend, dev = plan(world_size, backend=backend, device=device, local_rank=local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world_size > 1:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return RankGroup(rank=rank, size=world_size, device=dev, backend=backend)


def group_from_env(*, backend=None, device=None) -> RankGroup:
    """The group of a rank started by ``torchrun`` (``env://``)."""
    if dist.is_initialized():
        backend = dist.get_backend()
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if dist.is_initialized():
        _, dev = plan(world, backend=backend, device=device, local_rank=local)
        return RankGroup(rank=rank, size=world, device=dev, backend=backend)
    return init_group(rank, world, backend=backend, device=device, local_rank=local)


def in_torchrun() -> bool:
    """Whether this process is a rank that ``torchrun`` started."""
    return dist.is_initialized() or ("RANK" in os.environ and "WORLD_SIZE" in os.environ)


def _rank_main(rank, fn, world_size, args, backend, device, init_method, out_dir, threads):
    torch.set_num_threads(threads)
    group = init_group(rank, world_size, backend=backend, device=device, init_method=init_method)
    try:
        out = fn(group, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, world_size: int, args=(), *, backend=None, device=None,
           timeout_s: float | None = None, threads: int | None = None,
           rendezvous_dir: str | None = None) -> list:
    """Run ``fn(group, *args)`` on ``world_size`` spawned ranks of this
    host and return their results in rank order. ``fn`` must be a
    module-level function. On CUDA the kernels are built here first, so
    that no two ranks build into the same directory. A rank that raises,
    dies, outlives ``timeout_s`` (None: no limit on the whole run) or waits
    more than ``COLLECTIVE_TIMEOUT_S`` in one collective ends every rank,
    and this raises. Each rank takes ``threads`` CPU threads (None: its
    share of this host's cores); the rendezvous file goes in a new
    directory under ``rendezvous_dir`` (None: the system's temporary
    directory)."""
    plan(world_size, backend=backend, device=device, local_rank=world_size - 1)
    if resolve_device(device).type == "cuda":
        from ..cuda_build import build

        build(KERNEL_SOURCES)
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world_size)
    work = tempfile.mkdtemp(prefix="mmadmm_ranks_", dir=rendezvous_dir)
    try:
        init_method = "file://" + os.path.join(work, "rendezvous")
        ctx = torch.multiprocessing.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(fn, world_size, tuple(args), backend, device, init_method, work, threads))
        deadline = time.monotonic() + (timeout_s if timeout_s is not None else float("inf"))
        while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{world_size} ranks did not finish within {timeout_s} s")
        out = []
        for r in range(world_size):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)
