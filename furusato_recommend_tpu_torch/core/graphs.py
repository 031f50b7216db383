"""What the port's CUDA graphs share: the rule that picks what is captured,
the eager warm-up on the capture stream, and the capture's memory pool
measured.

A training step (``train/graphed.py``), an evaluation
(``eval/graphed.py``) and the serving tier's refresh and request tiles
(``serve.py``) are captured alike, on a CUDA device; under a mesh too, in
parts that hold device work alone, the collectives run eagerly between them
(``captured``). Each graph holds ``stats``: warm-up, capture and instantiate
host ms of its last capture, its pool's MiB, and the captures and replays so
far.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

__all__ = ["captured", "gathers_over_data", "new_stats", "on_capture_stream", "pool_measured"]


def gathers_over_data(mesh, config=None, model=None, evaluation: bool = False) -> bool:
    """Whether a program of this configuration runs a collective in its
    middle, between device work that depends on it both ways: under a mesh,
    the in-batch InfoNCE (``config.loss_fn``) and asage's views' InfoNCE
    (``model.ssl_weight``) gather the batch's rows over a data axis of more
    than one rank in the forward and sum their gradient over it in the
    backward (``core/mesh.py::gather_data_rows``); for an evaluation,
    ``--inference sample`` gathers each chunk's encodings over ``data``
    (``models/sage.py::propagate_sampled``). Every rank reads the same
    configuration, so every rank answers alike."""
    if mesh is None:
        return False
    if evaluation:
        return config is not None and config.inference == "sample" and hasattr(model, "propagate_sampled")
    in_batch = (config is not None and config.loss_fn == "infonce") or getattr(model, "ssl_weight", 0) > 0
    return in_batch and mesh.data > 1


def captured(mesh, device, config=None, model=None, evaluation: bool = False) -> bool:
    """Whether the steps (or, ``evaluation``, the evaluations) and serving
    programs of this configuration are replayed as CUDA graphs: on a CUDA
    device, with or without a mesh. A mesh's collectives (the whole-table
    gather, the gradient mean, the evaluation's candidates and sums) fall
    between whole pieces of device work, so its steps and evaluations are
    captured in parts and the collectives run eagerly between them, on gloo
    and on NCCL alike; only NCCL could record a collective inside a graph,
    and it refuses two ranks on one card. A configuration whose collective
    sits in the middle of its program (``gathers_over_data``) stays eager on
    every rank."""
    return torch.device(device).type == "cuda" and not gathers_over_data(mesh, config, model, evaluation)


def new_stats() -> dict:
    return {"warmup_ms": 0.0, "capture_ms": None, "instantiate_ms": None, "pool_mib": None,
            "captures": 0, "replays": 0}


def on_capture_stream(stream: torch.cuda.Stream, device, fn: Callable):
    """``fn()`` run eagerly on the capture stream, ordered after and before
    the current stream's work: (its result, host ms)."""
    t0 = time.perf_counter()
    here = torch.cuda.current_stream(device)
    stream.wait_stream(here)
    with torch.cuda.stream(stream):
        out = fn()
    here.wait_stream(stream)
    return out, 1e3 * (time.perf_counter() - t0)


@contextlib.contextmanager
def pool_measured(device, stats: dict):
    """Around a capture: the card idle and the allocator's free blocks given
    back first, then the memory the capture reserved recorded as its pool's
    MiB, and the capture counted."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    yield
    stats.update(pool_mib=(torch.cuda.memory_reserved(device) - reserved) / 2**20,
                 captures=stats["captures"] + 1)
