"""Profiler traces and device-memory snapshots (port of ``obs/profiler.py``).

``trace(log_dir)`` records a block with ``torch.profiler`` (CPU operations,
and the card's kernels when CUDA is there) and writes a Chrome trace JSON
into ``log_dir``, readable in Perfetto or ``chrome://tracing``.
``device_memory_stats`` reads the CUDA caching allocator's counters.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict

import torch

__all__ = ["trace", "device_memory_stats", "log_device_memory"]

_MIB = 1024 * 1024


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block: ``with trace("/tmp/trace"): ...`` writes
    ``{log_dir}/<host>_<pid>.<ms>.pt.trace.json``; yields the profiler."""
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)),
    ) as prof:
        yield prof


def device_memory_stats(device=None) -> Dict[str, float]:
    """{"mib_in_use", "peak_mib_in_use", "mib_limit"} of a CUDA device (the
    current one by default, when CUDA is there): the bytes the caching
    allocator holds for tensors now and at its peak, and the card's memory.
    Empty for the CPU, as the JAX package's is on a backend without stats."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "mib_in_use": stats.get("allocated_bytes.all.current", 0) / _MIB,
        "peak_mib_in_use": stats.get("allocated_bytes.all.peak", 0) / _MIB,
        "mib_limit": torch.cuda.get_device_properties(device).total_memory / _MIB,
    }


def log_device_memory(sink=None, prefix: str = "mem", device=None) -> Dict[str, float]:
    """``device_memory_stats``, also logged into ``sink`` as
    ``{prefix}/{key}`` when there are any."""
    stats = device_memory_stats(device)
    if sink is not None and stats:
        sink.log({f"{prefix}/{k}": v for k, v in stats.items()})
    return stats
