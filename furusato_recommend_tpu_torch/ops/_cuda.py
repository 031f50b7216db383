"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library ``_build/lib<name>-<hash>.so``, with a plain C interface that the
kernel's module binds through ``ctypes``. The hash covers the source, the
headers of ``csrc/`` it may include and the flags, so an edited source or
header is rebuilt. Nothing is built when this module is
imported: the first call that needs a library builds it, and ``build`` starts
one ``nvcc`` per source, all at once.

``launch`` calls a bound entry point with a stream (``stream``: the current
one of a device) as its last argument, switching the current device only when
it is another one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

__all__ = ["SOURCES", "build", "device_index", "launch", "library", "stream"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("streaming_topk", "streaming_topk_wide", "scatter_add_rows")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every library of ``names`` (default: all sources) that is not
    built yet, one nvcc process per source, started together. Returns
    {name: {"seconds": wall time, "log": nvcc's output}}; raises on a failure."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target)
    report, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _loaded[name] = lib
        return lib


def device_index(dev) -> int:
    """The index of a CUDA ``torch.device`` (the current device when it has
    none)."""
    return torch.cuda.current_device() if dev.index is None else dev.index


def launch(index: int, stream: int, fn, *args) -> int:
    """``fn(*args, stream)`` with device ``index`` current; returns what ``fn``
    returns (a CUDA error code)."""
    if torch.cuda.current_device() != index:
        with torch.cuda.device(index):
            return fn(*args, stream)
    return fn(*args, stream)


def stream(index: int) -> int:
    """The raw handle of device ``index``'s current stream, read without
    building a ``torch.cuda.Stream``."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream
