"""Partial-key cuckoo set over (u, v) int pairs (port of ``ops/cuckoo.py``).

The BPR sampler's negative-rejection test: membership in two independent
gathers whose addresses come from hash math, instead of a binary search whose
every probe depends on the previous one.

- Every inserted pair is found; a query that was not inserted is reported as
  present only on a full 32-bit fingerprint collision (about n / 2^32).
- The table is built on the host by ``build_cuckoo_set`` (numpy; the JAX
  package's C++ builder is not carried over, its numpy fallback is) and probed
  on any device by ``cuckoo_contains``. Both share the murmur3 ``fmix32`` slot
  math bit for bit with the JAX package, so the same pairs give the same table.

torch has no full uint32 arithmetic: on tensors, the 32-bit values live in
int64 and every product is masked back to its low 32 bits, which a wrapped
int64 product keeps exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["CuckooSet", "build_cuckoo_set", "cuckoo_contains"]

_C_KEY_U = 0x9E3779B1
_C_KEY_V = 0x85EBCA77
_C_H1 = 0xC2B2AE3D
_C_ALT = 0x165667B1
_FP_REMAP = 0x9E3779B1  # fingerprint 0 is the empty-slot sentinel
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_MASK32 = 0xFFFFFFFF


def _fmix32(h):
    """murmur3 finalizer: numpy uint32 arrays (wrapping), or int64 tensors
    holding uint32 values."""
    if isinstance(h, torch.Tensor):
        h = h ^ (h >> 16)
        h = (h * _M1) & _MASK32
        h = h ^ (h >> 13)
        h = (h * _M2) & _MASK32
        return h ^ (h >> 16)
    h = h ^ (h >> 16)
    h = h * np.uint32(_M1)
    h = h ^ (h >> 13)
    h = h * np.uint32(_M2)
    return h ^ (h >> 16)


def _fingerprints(u, v):
    """32-bit fingerprint of (u, v), never 0: numpy uint32 for numpy input,
    int64 holding the uint32 value for tensors."""
    if isinstance(u, torch.Tensor):
        key = ((u.long() & _MASK32) * _C_KEY_U & _MASK32) ^ (
            (v.long() & _MASK32) * _C_KEY_V & _MASK32
        )
        fp = _fmix32(key)
        return torch.where(fp == 0, torch.full_like(fp, _FP_REMAP), fp)
    u32 = np.asarray(u).astype(np.uint32)
    v32 = np.asarray(v).astype(np.uint32)
    with np.errstate(over="ignore"):
        key = u32 * np.uint32(_C_KEY_U) ^ (v32 * np.uint32(_C_KEY_V))
        fp = _fmix32(key)
    return np.where(fp == 0, np.uint32(_FP_REMAP), fp)


@dataclass(frozen=True)
class CuckooSet:
    table: torch.Tensor  # [S] int64 holding uint32 fingerprints (0 = empty), S a power of two
    mask: int = 0

    def to(self, device) -> "CuckooSet":
        return CuckooSet(self.table.to(device), self.mask)


def _build_numpy(fps: np.ndarray, table: np.ndarray, max_kicks: int) -> int:
    """Insert every fingerprint into ``table`` (uint32, zeroed) by cuckoo
    eviction walks; returns the number of keys that found no slot. The hash
    math is vectorised; the walk uses plain Python ints."""
    mask = len(table) - 1
    with np.errstate(over="ignore"):
        h1s = (_fmix32(fps ^ np.uint32(_C_H1)) & np.uint32(mask)).astype(np.int64)
        alt_offs = (_fmix32(fps ^ np.uint32(_C_ALT)) & np.uint32(mask)).astype(np.int64)
    alt_of = {int(fp): int(off) for fp, off in zip(fps, alt_offs)}
    failed = 0
    for fp_, s1 in zip(fps.astype(np.int64), h1s):
        fp, s1 = int(fp_), int(s1)
        if table[s1] == fp:
            continue
        s2 = s1 ^ alt_of[fp]
        if table[s2] == fp:
            continue
        if table[s1] == 0:
            table[s1] = fp
            continue
        if table[s2] == 0:
            table[s2] = fp
            continue
        cur, slot, placed = fp, s1, False
        for _ in range(max_kicks):
            cur, table[slot] = int(table[slot]), cur
            slot = slot ^ alt_of[cur]
            if table[slot] == 0 or table[slot] == cur:
                table[slot] = cur
                placed = True
                break
        if not placed:
            failed += 1
    return failed


def build_cuckoo_set(u: np.ndarray, v: np.ndarray, load: float = 0.35) -> CuckooSet:
    """Host build over int pair arrays, as a CPU tensor. Doubles the table
    until every key places: a failed eviction walk strands a displaced key,
    so the whole table is rebuilt."""
    fps = np.ascontiguousarray(_fingerprints(np.asarray(u), np.asarray(v)))
    n = len(fps)
    size = 1 << max(int(np.ceil(np.log2(max(n, 1) / load))), 4)
    while True:
        table = np.zeros(size, dtype=np.uint32)
        if _build_numpy(fps, table, 500) == 0:
            return CuckooSet(table=torch.from_numpy(table.astype(np.int64)), mask=size - 1)
        size *= 2


def cuckoo_contains(cs: CuckooSet, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Elementwise membership of broadcastable (u, v) int tensors: two
    independent gathers and fingerprint compares."""
    u_b, v_b = torch.broadcast_tensors(torch.as_tensor(u), torch.as_tensor(v))
    fp = _fingerprints(u_b.reshape(-1), v_b.reshape(-1))
    s1 = _fmix32(fp ^ _C_H1) & cs.mask
    s2 = s1 ^ (_fmix32(fp ^ _C_ALT) & cs.mask)
    hit = (cs.table[s1] == fp) | (cs.table[s2] == fp)
    return hit.reshape(u_b.shape)
