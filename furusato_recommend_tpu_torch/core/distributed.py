"""The process world of a multi-device run (port of ``core/distributed.py``).

Every rank of the port is a process. ``initialize_multihost`` joins the world
through ``torch.distributed.init_process_group``: from torchrun's environment
(``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``, the
``env://`` rendezvous) or from an explicit ``init_method``, rank and world
size. A requested world that cannot be realised raises, after ``timeout_s``
at most, and a world of another size than the one asked for raises too: the
run never degrades to a smaller world.

The backend follows from the device each rank asked for
(``default_backend``): NCCL where every rank has a card of its own, gloo on
the CPU and where the ranks of a host share one named card. gloo also takes
CUDA tensors (it stages them through host memory), which is how several
ranks share one card: NCCL refuses two ranks on one device. Either way a
mesh's collectives run eagerly between its CUDA graphs (the captured parts
of a step or an evaluation hold device work alone: ``core/mesh.py``), so
the port never needs NCCL's capture of a collective.

Randomness (the JAX package's two regimes): the trainer's sampling stream is
shared, seeded alike on every rank, so that a mesh draws what one process
draws; ``host_divergent_generator`` is the per-rank stream of the reference's
DDP recipe (``np.random.seed(1000 * rank)``), folded with the rank as JAX
folds its key with the process index.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize_multihost", "is_primary_host", "host_divergent_generator", "rank_device",
    "local_rank", "default_backend", "shutdown",
]

DEFAULT_TIMEOUT_S = 300.0


def local_rank() -> int:
    """This process's index on its host (torchrun's ``LOCAL_RANK``; the
    global rank without it, 0 without a world)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``cuda`` (or None) means ``cuda:{LOCAL_RANK}``,
    which must exist; an indexed device (``cuda:0``) is taken as it is, on
    every rank; ``cpu`` is the CPU. Ranks are never folded onto the cards by
    a modulo."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", local_rank())
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank device {dev} does not exist: this host has {torch.cuda.device_count()} card(s); "
            "launch at most one rank a card, or name one card (cuda:0) for every rank"
        )
    return dev


def default_backend(device=None) -> str:
    """The collectives' backend for ranks that asked for ``device``: gloo on
    the CPU; gloo for a named card (``cuda:0``) when this host runs more than
    one rank (torchrun's ``LOCAL_WORLD_SIZE``), since they all share it and
    NCCL refuses two ranks on one card; NCCL otherwise (``cuda``, one card a
    rank). Every rank asks for the same device, so every rank picks the same
    backend. Both run a mesh's collectives eagerly between its captured
    parts (``core/mesh.py``), never inside a CUDA graph."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return "gloo"
    if dev.index is not None and int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > 1:
        return "gloo"
    return "nccl"


def initialize_multihost(
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    init_method: Optional[str] = None,
    backend: Optional[str] = None,
    device=None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join the world of ``world_size`` processes; a no-op returning False
    when no world is asked for (no ``world_size`` and no ``init_method``).

    ``init_method`` None is the ``env://`` rendezvous of torchrun's
    environment; otherwise a ``tcp://`` or ``file://`` address, with
    ``rank``. ``backend``: ``nccl`` or ``gloo``; None is
    ``default_backend(device)``. A CUDA ``device`` with an index becomes
    this process's current device (NCCL's communicators live on it). Raises
    when the rendezvous does not complete within ``timeout_s`` (default 300
    s), and when the realised world's size is not ``world_size``. Joining
    again a world of the same size is a no-op."""
    if world_size is None and init_method is None:
        return False
    dev = torch.device("cpu" if device is None else device)
    if backend is None:
        backend = default_backend(dev)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {}
        if init_method is not None:
            kw = {"init_method": init_method, "world_size": world_size, "rank": rank}
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout_s or DEFAULT_TIMEOUT_S), **kw
        )
    if world_size is not None and dist.get_world_size() != world_size:
        raise RuntimeError(
            f"the run asked for a world of {world_size} processes but the rendezvous formed one of "
            f"{dist.get_world_size()}; refusing to run on a world of another size"
        )
    return True


def shutdown() -> None:
    """Leave the world, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary_host() -> bool:
    """Rank 0, or True without a world: the one process that writes
    checkpoints, logs and metrics files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def host_divergent_generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` whose stream differs from rank to
    rank: seeded from (seed, rank); rank 0 without a world."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    state = np.random.SeedSequence([int(seed), rank]).generate_state(1, dtype=np.uint64)[0]
    gen = torch.Generator(device=torch.device("cpu" if device is None else device))
    gen.manual_seed(int(state))
    return gen
