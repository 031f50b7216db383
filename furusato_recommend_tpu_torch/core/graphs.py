"""What the port's CUDA graphs share: the rule that picks what is captured,
the eager warm-up on the capture stream, and the capture's memory pool
measured.

A training step (``train/graphed.py``), an evaluation
(``eval/graphed.py``) and the serving tier's refresh and request tiles
(``serve.py``) are captured alike: without a mesh (whose gloo collectives a
capture cannot record), on a CUDA device. Each graph holds ``stats``:
warm-up, capture and instantiate host ms of its last capture, its pool's
MiB, and the captures and replays so far.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

__all__ = ["captured", "new_stats", "on_capture_stream", "pool_measured"]


def captured(mesh, device) -> bool:
    """Whether the steps, evaluations and serving programs of this
    configuration are replayed as CUDA graphs: without a mesh, on a CUDA
    device."""
    return mesh is None and torch.device(device).type == "cuda"


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
