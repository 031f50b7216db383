"""ctypes bindings of the port's host C++ (``csrc/host/furusato_host.cpp``,
the port's copy of the JAX package's ``native/furusato_native.cpp``).

- ``lev_ratio`` / ``lev_ratio_consecutive``: the python-Levenshtein ratio
  (indel 1, substitution 2) of the product-ID dedup (``ids.py``);
- ``parse_adjacency_text``: ``uid item ...`` text files to COO arrays;
- ``cuckoo_build``: the cuckoo membership table of ``ops/cuckoo.py``.

The library is built with ``g++ -O3 -shared -fPIC`` into ``_build/`` at first
use (nothing is built when this module is imported); its file name carries a
hash of the source and the flags, so an edited source is rebuilt. Deviation
(no silent fallback): where the build fails, the first call raises. The JAX
package prints and falls back to Python.

Beside each bound function is its plain Python version (``*_reference``),
which only the tests use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "library",
    "lev_ratio",
    "lev_ratio_consecutive",
    "parse_adjacency_text",
    "cuckoo_build",
    "lev_ratio_reference",
    "lev_ratio_consecutive_reference",
    "parse_adjacency_reference",
]

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "csrc" / "host" / "furusato_host.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_I64 = ctypes.c_int64
_P_U32 = ctypes.POINTER(ctypes.c_uint32)
_P_I64 = ctypes.POINTER(ctypes.c_int64)
_P_F64 = ctypes.POINTER(ctypes.c_double)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _target() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libfurusato_host-{h.hexdigest()[:16]}.so"


def library() -> ctypes.CDLL:
    """The loaded host library, built on first use; raises if g++ fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = _target()
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                ["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)], capture_output=True, text=True
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed to build {SRC.name}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        lib.lev_ratio.restype = ctypes.c_double
        lib.lev_ratio.argtypes = [_P_U32, ctypes.c_int32, _P_U32, ctypes.c_int32]
        lib.lev_ratio_consecutive.restype = None
        lib.lev_ratio_consecutive.argtypes = [_P_U32, _P_I64, _I64, _P_F64]
        lib.parse_adjacency.restype = _I64
        lib.parse_adjacency.argtypes = [ctypes.c_char_p, _I64, _P_I64, _P_I64, _I64]
        lib.cuckoo_build.restype = _I64
        lib.cuckoo_build.argtypes = [_P_U32, _I64, _P_U32, _I64, _I64]
        _lib = lib
        return lib


def _codepoints(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32)


def lev_ratio(a: str, b: str) -> float:
    """python-Levenshtein's ``ratio`` (indel 1, substitution 2) on code points."""
    lib = library()
    ca, cb = _codepoints(a), _codepoints(b)
    return lib.lev_ratio(ca.ctypes.data_as(_P_U32), len(ca), cb.ctypes.data_as(_P_U32), len(cb))


def lev_ratio_consecutive(names: Sequence) -> np.ndarray:
    """Ratios of (names[i], names[i + 1]) for every i."""
    lib = library()
    rows = [_codepoints(str(s)) for s in names]
    offsets = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum([len(r) for r in rows], out=offsets[1:])
    flat = np.ascontiguousarray(np.concatenate(rows) if rows else np.empty(0, np.uint32))
    out = np.empty(max(len(rows) - 1, 0), dtype=np.float64)
    lib.lev_ratio_consecutive(
        flat.ctypes.data_as(_P_U32), offsets.ctypes.data_as(_P_I64), len(rows), out.ctypes.data_as(_P_F64)
    )
    return out


def parse_adjacency_text(path) -> Tuple[np.ndarray, np.ndarray]:
    """'uid item1 item2 ...' lines of a file to COO (users, items) int64 arrays."""
    lib = library()
    data = Path(path).read_bytes()
    n = lib.parse_adjacency(data, len(data), None, None, 0)
    users = np.empty(n, np.int64)
    items = np.empty(n, np.int64)
    if n:
        lib.parse_adjacency(data, len(data), users.ctypes.data_as(_P_I64), items.ctypes.data_as(_P_I64), n)
    return users, items


def cuckoo_build(fps: np.ndarray, table: np.ndarray, max_kicks: int) -> int:
    """Insert the non-zero uint32 fingerprints ``fps`` into ``table`` (uint32,
    zeroed, a power of two long) in place; returns the number of keys that
    found no slot within ``max_kicks`` evictions."""
    if fps.dtype != np.uint32 or table.dtype != np.uint32:
        raise TypeError(f"cuckoo_build takes uint32 arrays, not {fps.dtype} and {table.dtype}")
    if not (fps.flags.c_contiguous and table.flags.c_contiguous and table.flags.writeable):
        raise ValueError("cuckoo_build needs contiguous arrays and a writeable table")
    size = len(table)
    if size == 0 or size & (size - 1):
        raise ValueError(f"the table's length {size} is not a power of two")
    return int(library().cuckoo_build(
        fps.ctypes.data_as(_P_U32), len(fps), table.ctypes.data_as(_P_U32), size, int(max_kicks)
    ))


# -- plain versions, for the tests --------------------------------------------


def lev_ratio_reference(a: str, b: str) -> float:
    """``lev_ratio`` by the textbook dynamic programme in Python."""
    ca, cb = [ord(c) for c in a], [ord(c) for c in b]
    la, lb = len(ca), len(cb)
    if la + lb == 0:
        return 1.0
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            sub = prev[j - 1] + (0 if ca[i - 1] == cb[j - 1] else 2)
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub)
        prev = cur
    return (la + lb - prev[lb]) / (la + lb)


def lev_ratio_consecutive_reference(names: Sequence) -> np.ndarray:
    return np.array([lev_ratio_reference(str(a), str(b)) for a, b in zip(names[:-1], names[1:])],
                    dtype=np.float64)


def parse_adjacency_reference(path) -> Tuple[np.ndarray, np.ndarray]:
    """``parse_adjacency_text`` for well-formed files, in Python."""
    users, items = [], []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        uid = int(parts[0])
        for t in parts[1:]:
            users.append(uid)
            items.append(int(t))
    return np.asarray(users, np.int64), np.asarray(items, np.int64)
