"""Fused full-catalog score + train-positive mask + top-k (port of
``ops/pallas_topk.py::streaming_topk`` and of the masked top-k in
``serve.py::Recommender``).

``masked_topk`` is the serving path's kernel. For a CUDA tensor it launches one
of two hand-written kernels, or raises: for k <= ``MAX_K`` = 128 the kernel of
``csrc/streaming_topk.cu`` (blocks of 32 users x one item segment keep each
row's best k in registers, then a merge per row), above it the radix select of
``csrc/streaming_topk_wide.cu`` (``masked_topk_wide``: passes that each count
one 8-bit digit of every score's key and write out the keys at or above the
chosen prefix once they fit, then a sort per row; see the notes in the
sources).
For CPU tensors both run ``masked_topk_reference``, the plain PyTorch version
of the same function, which the CPU tests hold against the JAX package;
``wide_topk_model`` is a plain model of the radix select's stages, for those
tests only.

Semantics, shared by both and by the JAX package:

- score float32 = <U[users[b]], I[j]>, then the sigmoid if asked;
- every j in the user's sorted train row (mask CSR) gets exactly -1024.0;
  masked items are not removed and still rank when fewer than k items remain;
- order: value descending, then item id ascending on ties (``lax.top_k``);
- any 1 <= k <= M, one kernel call whatever k; ``k > M`` raises, as
  ``lax.top_k`` does; nothing waits for the card;
- user ids outside [0, N) are clamped into it: the score row and the mask
  row are both those of the clamped id. This is a deviation. The JAX
  ``Recommender._topk`` wraps an id in [-N, 0) once (-3 scores row N - 3)
  and clamps the rest, and takes the mask row from ``indptr`` [N + 1], so
  id u in [-N - 1, -2] gets row u + N + 1's mask and -1 or any id >= N gets
  none (``tests/test_torch_topk.py`` shows both). Nothing checks ids on the
  host, so the CUDA path never waits for the card: callers that hold ids on
  the host check them there (``serve.Recommender.recommend`` raises
  ``ValueError``).

Scores that are NaN have no defined rank.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..data.graph import CSR
from . import _cuda
from .csr_search import csr_gather_padded

__all__ = [
    "masked_topk", "masked_topk_wide", "masked_topk_reference", "wide_topk_model", "plan_tiles",
    "MASK_SENTINEL", "MAX_K",
]

MASK_SENTINEL = -(1 << 10)
MAX_K = 128  # k that csrc/streaming_topk.cu takes: its lists in registers and shared memory
MAX_DIM = 4096
USER_TILE = 32  # users per block, csrc/topk_tile.cuh kBU
ITEM_TILE = 128  # items per tile, kTI
WIDE_SLACK = 256  # the radix select stops once at most next_pow2(k + 256) keys remain
WIDE_FILTER = 8192  # candidates a row of the radix select may write while it counts
WIDE_MAX_SEGMENT = 511 * ITEM_TILE  # its 16-bit shared counts hold a segment's items

#: kernel launches since the count was last set to 0: one per masked_topk or
#: masked_topk_wide call on CUDA tensors, whichever kernel it takes
launches = 0
#: of those, the calls that took the radix select (csrc/streaming_topk_wide.cu)
wide_launches = 0


def _check(user_emb, item_emb, users, k, mask_indptr, mask_indices) -> None:
    if user_emb.dim() != 2 or item_emb.dim() != 2 or user_emb.shape[1] != item_emb.shape[1]:
        raise ValueError(
            f"need user_emb [N, d] and item_emb [M, d], got {tuple(user_emb.shape)} "
            f"and {tuple(item_emb.shape)}"
        )
    if users.dim() != 1:
        raise ValueError(f"users must be 1-D, got shape {tuple(users.shape)}")
    m = item_emb.shape[0]
    if not 1 <= k <= m:
        raise ValueError(f"k={k} must be in [1, M={m}]")
    if (mask_indptr is None) != (mask_indices is None):
        raise ValueError("pass both mask_indptr and mask_indices, or neither")
    if mask_indptr is not None and mask_indptr.shape[0] != user_emb.shape[0] + 1:
        raise ValueError(
            f"mask_indptr has {mask_indptr.shape[0]} entries, need N + 1 = {user_emb.shape[0] + 1}"
        )


def _scores(user_emb, item_emb, users, mask_indptr, mask_indices, sigmoid) -> torch.Tensor:
    """The [B, M] float32 scores of the plain version: ids clamped into [0, N),
    the product in full float32 (TF32 off for the call on CUDA), the sigmoid if
    asked, -1024 over each row's train items."""
    users = users.long().clamp(0, user_emb.shape[0] - 1)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        s = (user_emb[users].float() @ item_emb.float().T).float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if sigmoid:
        s = torch.sigmoid(s)
    if mask_indptr is not None and users.numel():
        mask = CSR(mask_indptr, mask_indices)
        pad_to = max(int(mask.degrees()[users].max()), 1)
        pos, valid = csr_gather_padded(mask, users, pad_to)
        rows = torch.arange(users.shape[0], device=s.device)[:, None].expand_as(pos)
        s.index_put_(
            (rows[valid], pos[valid].long()),
            torch.tensor(float(MASK_SENTINEL), device=s.device),
        )
    return s


def masked_topk_reference(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    users: torch.Tensor,
    k: int,
    mask_indptr: Optional[torch.Tensor] = None,
    mask_indices: Optional[torch.Tensor] = None,
    sigmoid: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``masked_topk``: ids clamped into [0, N), as
    the kernels clamp them (not as the JAX package treats negative ids; see
    the module docstring), the [B, M] score matrix, then a stable descending
    sort."""
    _check(user_emb, item_emb, users, k, mask_indptr, mask_indices)
    s = _scores(user_emb, item_emb, users, mask_indptr, mask_indices, sigmoid)
    # columns are item ids in ascending order, so a stable sort breaks value
    # ties by ascending id
    vals, ids = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), ids[:, :k].contiguous()


def wide_cap(k: int) -> int:
    """Candidates a row of the radix select may hold: the power of two at or
    above k + ``WIDE_SLACK``."""
    return 1 << (k + WIDE_SLACK - 1).bit_length()


def value_keys(v: torch.Tensor) -> torch.Tensor:
    """The radix select's 32-bit key of float32 values, as int64 in [0, 2^32):
    a larger value has a larger key; -0.0 is keyed as +0.0."""
    b = v.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    b = torch.where(b == 0x80000000, torch.zeros_like(b), b)
    return torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)


def key_values(key: torch.Tensor) -> torch.Tensor:
    """The float32 values of ``value_keys`` (a zero comes back as +0.0)."""
    b = torch.where(key >= 0x80000000, key & 0x7FFFFFFF, key ^ 0xFFFFFFFF)
    return torch.where(b >= 1 << 31, b - (1 << 32), b).to(torch.int32).view(torch.float32)


def wide_topk_model(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    users: torch.Tensor,
    k: int,
    mask_indptr: Optional[torch.Tensor] = None,
    mask_indices: Optional[torch.Tensor] = None,
    sigmoid: bool = False,
    cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The radix select of ``csrc/streaming_topk_wide.cu`` stage by stage, in
    plain PyTorch, for the CPU tests (nothing on a CUDA path calls it).

    Each score s[b, j] (``_scores``) becomes the key (``value_keys(s)``,
    M - 1 - j), ordered as one 64-bit unsigned number: value descending, then
    id ascending, every key unique. Levels 0-3 take the value word's bytes
    from the highest, then the bytes of the id field (``ceil(bits(M - 1) /
    8)`` levels). At each level a row not yet done counts the digit of every
    key that matches its prefix (a 256-bin histogram), takes the highest bin
    at which the count of keys from the top reaches k, and extends its
    prefix by that bin; it is done once the keys at or above the prefix
    number at most ``cap`` (default ``wide_cap(k)``), or at the last level.
    The keys at or above the prefix (k to cap of them) are then sorted and
    the first k kept. (The kernel writes a row's keys while it still counts,
    once they fit its candidate row: that changes when they are written, not
    which.) Returns (values float32 [B, k], ids int64 [B, k], the
    level after which each row was done, int64 [B])."""
    _check(user_emb, item_emb, users, k, mask_indptr, mask_indices)
    cap = wide_cap(k) if cap is None else cap
    if cap < k:
        raise ValueError(f"cap={cap} must be at least k={k}")
    s = _scores(user_emb, item_emb, users, mask_indptr, mask_indices, sigmoid)
    b, m = s.shape
    hi = value_keys(s)
    lo = (m - 1 - torch.arange(m, device=s.device)).expand(b, m)
    id_levels = -(-(m - 1).bit_length() // 8)
    n_levels = 4 + id_levels
    prefix_hi = torch.zeros(b, dtype=torch.int64, device=s.device)
    prefix_lo = torch.zeros_like(prefix_hi)
    taken = torch.zeros_like(prefix_hi)
    done = torch.full_like(prefix_hi, -1)
    match = torch.ones((b, m), dtype=torch.bool, device=s.device)  # keys under the prefix
    for level in range(n_levels):
        active = done < 0
        if not bool(active.any()):
            break
        if level < 4:
            digit = (hi >> (24 - 8 * level)) & 0xFF
        else:
            digit = (lo >> (8 * (id_levels - 1 - (level - 4)))) & 0xFF
        hist = torch.zeros((b, 256), dtype=torch.int64, device=s.device)
        hist.scatter_add_(1, digit, (match & active[:, None]).long())
        from_top = hist.flip(1).cumsum(1).flip(1)  # keys at digit >= bin
        need = k - taken
        bin_ = ((from_top >= need[:, None]).sum(1) - 1).clamp(min=0)  # rows done: any bin
        in_bin = hist.gather(1, bin_[:, None])[:, 0]
        above = from_top.gather(1, bin_[:, None])[:, 0] - in_bin
        if level < 4:
            prefix_hi = torch.where(active, prefix_hi | (bin_ << (24 - 8 * level)), prefix_hi)
        else:
            shift = 8 * (id_levels - 1 - (level - 4))
            prefix_lo = torch.where(active, prefix_lo | (bin_ << shift), prefix_lo)
        match &= digit == bin_[:, None]
        finished = active & ((taken + above + in_bin <= cap) | (level == n_levels - 1))
        done = torch.where(finished, torch.full_like(done, level), done)
        taken = torch.where(active & ~finished, taken + above, taken)
    # the keys at or above each row's prefix, in any order, then sorted
    take = (hi > prefix_hi[:, None]) | ((hi == prefix_hi[:, None]) & (lo >= prefix_lo[:, None]))
    count = take.sum(1)
    if b and (int(count.min()) < k or int(count.max()) > cap):
        raise AssertionError(f"rows hold {int(count.min())}-{int(count.max())} keys, need k={k} to cap={cap}")
    key = torch.where(take, (hi << 31) | lo, torch.full_like(hi, -1))  # lo < 2^31
    best = torch.sort(key, dim=1, descending=True).values[:, :k]
    return key_values(best >> 31), m - 1 - (best & ((1 << 31) - 1)), done


@functools.lru_cache(maxsize=1024)
def plan_tiles(
    n_rows: int, m_items: int, sm_count: int, blocks_per_sm: int
) -> Tuple[int, int, int]:
    """(user tiles, item segments, items per segment) of pass 1: a block owns
    ``USER_TILE`` rows x one segment, and a segment is a whole number of
    ``ITEM_TILE``-item tiles. The grid has at least two blocks per SM wherever
    there are that many (user tile, item tile) pairs; among such cuts, the one
    with the fewest waves (``blocks_per_sm`` blocks on each SM at once) times
    the tiles a block walks (plus one for a block's fixed work: its setup, its
    last merges and its list in pass 2)."""
    n_ut = -(-n_rows // USER_TILE)
    n_tiles = -(-m_items // ITEM_TILE)
    need = min(2 * sm_count, n_ut * n_tiles)
    slots = blocks_per_sm * sm_count
    best = (None, 1)
    for per_seg in range(1, n_tiles + 1):
        blocks = n_ut * -(-n_tiles // per_seg)
        if blocks < need:
            break
        cost = -(-blocks // slots) * (per_seg + 1)
        if best[0] is None or cost <= best[0]:  # ties go to fewer segments
            best = (cost, per_seg)
    seg_len = best[1] * ITEM_TILE
    return n_ut, -(-m_items // seg_len), seg_len


@functools.lru_cache(maxsize=1024)
def plan_wide(
    n_rows: int, m_items: int, sm_count: int, blocks_per_sm: int
) -> Tuple[int, int, int]:
    """(user tiles, item segments, items per segment) of the radix select's
    passes: as many segments as fit the user tiles into one wave
    (``blocks_per_sm`` blocks on each SM), each a whole number of
    ``ITEM_TILE``-item tiles and at most ``WIDE_MAX_SEGMENT`` items. A radix
    pass's block pays several round trips to memory before its first tile and
    after its last, so fewer, longer blocks beat a second wave."""
    n_ut = -(-n_rows // USER_TILE)
    n_tiles = -(-m_items // ITEM_TILE)
    n_seg = max(1, min(n_tiles, blocks_per_sm * sm_count // n_ut))
    seg_len = min(-(-n_tiles // n_seg) * ITEM_TILE, WIDE_MAX_SEGMENT)
    return n_ut, -(-m_items // seg_len), seg_len


_ARGTYPES = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 6
    + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 4
)
_WIDE_ARGTYPES = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 6
    + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 5
    + [ctypes.c_void_p] * 5
)
_fns = {}  # entry point name -> bound function
_sm_count = {}  # device index -> SMs
_occupancy = {}  # (device index, kernel, d <= 64) -> pass-1 or wide_radix_pass blocks per SM


def _entry(lib: str, name: str, argtypes, restype=ctypes.c_int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_cuda.library(lib), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _fns[name] = fn
    return fn


def _occupancy_query(idx: int, key, query) -> int:
    got = _occupancy.get(key)
    if got is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = query(ctypes.byref(out))
        if err != 0 or out.value < 1:
            raise RuntimeError(f"masked_topk occupancy query failed: CUDA error {err}, "
                               f"{out.value} blocks per SM")
        got = _occupancy[key] = out.value
    return got


def _blocks_per_sm(idx: int, k: int, d: int) -> int:
    """Pass-1 blocks that one SM of device ``idx`` holds at once for this k
    and d, from the occupancy API; read once per device and instantiation."""
    fn = _entry("streaming_topk", "masked_topk_blocks_per_sm",
                [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    return _occupancy_query(idx, (idx, (k > 32) + (k > 64), d <= 64), lambda out: fn(k, d, out))


def _wide_blocks_per_sm(idx: int, d: int) -> int:
    """wide_radix_pass blocks that one SM of device ``idx`` holds at once at this
    d (resident user rows or not), from the occupancy API."""
    fn = _entry("streaming_topk_wide", "masked_topk_wide_blocks_per_sm",
                [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    return _occupancy_query(idx, (idx, "wide", d <= 64), lambda out: fn(d, out))


def _prepare(user_emb, item_emb, users, mask_indptr, mask_indices):
    """Checks both kernels share; returns (users as int32 or int64, device
    index, SMs)."""
    dev = user_emb.device
    tensors = [user_emb, item_emb, users] + (
        [mask_indptr, mask_indices] if mask_indptr is not None else []
    )
    if any(t.device != dev for t in tensors):
        raise ValueError(f"all tensors must be on {dev}")
    for name, t in (("user_emb", user_emb), ("item_emb", item_emb)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got {t.dtype}")
    for name, t in (("mask_indptr", mask_indptr), ("mask_indices", mask_indices)):
        if t is not None and (t.dtype != torch.int32 or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32, got {t.dtype}")
    n, d = user_emb.shape
    if d > MAX_DIM:
        raise ValueError(f"the CUDA kernel takes d <= {MAX_DIM}, got d={d}")
    if item_emb.shape[0] >= 2**31 - 1 or n >= 2**31:
        raise ValueError("the CUDA kernel takes int32 user and item ids")
    if -(-users.shape[0] // USER_TILE) > 65535:
        raise ValueError(f"the CUDA kernel takes at most {65535 * USER_TILE} users a call, "
                         f"got {users.shape[0]}")
    # ids are clamped into [0, N) on the device: no host check, no wait
    if users.dtype not in (torch.int32, torch.int64) or not users.is_contiguous():
        users = users.to(torch.int64).contiguous()
    idx = _cuda.device_index(dev)
    sms = _sm_count.get(idx)
    if sms is None:
        sms = _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return users, idx, sms


def _launch(user_emb, item_emb, users, k, mask_indptr, mask_indices, sigmoid):
    """One launch of the k <= MAX_K kernel."""
    global launches
    if k > MAX_K:
        raise ValueError(f"csrc/streaming_topk.cu takes k <= {MAX_K}, got k={k}")
    users, idx, sms = _prepare(user_emb, item_emb, users, mask_indptr, mask_indices)
    n, d = user_emb.shape
    m, b = item_emb.shape[0], users.shape[0]
    out_v = torch.empty((b, k), dtype=torch.float32, device=user_emb.device)
    out_i = torch.empty((b, k), dtype=torch.int64, device=user_emb.device)
    if b == 0:
        return out_v, out_i
    _, n_seg, seg_len = plan_tiles(b, m, sms, _blocks_per_sm(idx, k, d))
    cand = torch.empty(2 * b * n_seg * k, dtype=torch.int32, device=user_emb.device)
    fn = _entry("streaming_topk", "masked_topk_launch", _ARGTYPES)
    err = _cuda.launch(
        idx, _cuda.stream(idx), fn,
        user_emb.data_ptr(), item_emb.data_ptr(), users.data_ptr(),
        int(users.dtype == torch.int64), b, n, m, d, k,
        None if mask_indptr is None else mask_indptr.data_ptr(),
        None if mask_indices is None else mask_indices.data_ptr(),
        int(bool(sigmoid)), n_seg, seg_len,
        cand.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
    )
    if err != 0:
        raise RuntimeError(f"masked_topk kernel launch failed: CUDA error {err}")
    launches += 1
    return out_v, out_i


def wide_kernels(m: int) -> dict:
    """Kernel name -> launches of one radix-select call over M items:
    ``wide_radix_pass`` once a digit level (the value word's 4 bytes and
    ``ceil(bits(M - 1) / 8)`` of the id) and once more to collect, then
    ``wide_sort_rows``."""
    return {"wide_radix_pass": 4 + -(-(m - 1).bit_length() // 8) + 1, "wide_sort_rows": 1}


def wide_scratch_words(b: int) -> int:
    """4-byte words of the radix select's zeroed state for B rows: each row's
    prefix (2), histogram (256), keys above, level, filter flag and cursor
    (4); a ticket a user tile (the layout of ``masked_topk_wide_launch``)."""
    return 262 * b + -(-b // USER_TILE)


def wide_stride(k: int, m: int) -> int:
    """Candidates a row of the radix select may write: ``wide_cap(k)``, or up
    to ``WIDE_FILTER`` (and the power of two at or above M) when that is more,
    so that a row writes its keys while it still counts."""
    return max(wide_cap(k), min(WIDE_FILTER, 1 << (m - 1).bit_length()))


def _launch_wide(user_emb, item_emb, users, k, mask_indptr, mask_indices, sigmoid):
    """One call of the radix select (any 1 <= k <= M)."""
    global launches, wide_launches
    users, idx, sms = _prepare(user_emb, item_emb, users, mask_indptr, mask_indices)
    n, d = user_emb.shape
    m, b = item_emb.shape[0], users.shape[0]
    dev = user_emb.device
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int64, device=dev)
    if b == 0:
        return out_v, out_i
    _, n_seg, seg_len = plan_wide(b, m, sms, _wide_blocks_per_sm(idx, d))
    cap, stride = wide_cap(k), wide_stride(k, m)
    scratch = torch.zeros(wide_scratch_words(b), dtype=torch.int32, device=dev)
    cand = torch.empty(b * stride, dtype=torch.int64, device=dev)
    fn = _entry("streaming_topk_wide", "masked_topk_wide_launch", _WIDE_ARGTYPES)
    err = _cuda.launch(
        idx, _cuda.stream(idx), fn,
        user_emb.data_ptr(), item_emb.data_ptr(), users.data_ptr(),
        int(users.dtype == torch.int64), b, n, m, d, k,
        None if mask_indptr is None else mask_indptr.data_ptr(),
        None if mask_indices is None else mask_indices.data_ptr(),
        int(bool(sigmoid)), n_seg, seg_len, cap, stride,
        scratch.data_ptr(), cand.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
    )
    if err != 0:
        raise RuntimeError(f"masked_topk_wide kernel launch failed: CUDA error {err}")
    launches += 1
    wide_launches += 1
    return out_v, out_i


def _host_only(item_emb, users, mask_indptr, mask_indices) -> None:
    tensors = [item_emb, users] + ([mask_indptr, mask_indices] if mask_indptr is not None else [])
    if any(t.is_cuda for t in tensors):
        raise ValueError("mixed CPU and CUDA tensors")


def masked_topk_wide(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    users: torch.Tensor,
    k: int,
    mask_indptr: Optional[torch.Tensor] = None,
    mask_indices: Optional[torch.Tensor] = None,
    sigmoid: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``masked_topk`` through the radix select of
    ``csrc/streaming_topk_wide.cu`` at any k (``masked_topk`` takes it for k >
    ``MAX_K``; the card checks also hold it at smaller k). CUDA tensors launch
    it; CPU tensors run the plain version."""
    _check(user_emb, item_emb, users, k, mask_indptr, mask_indices)
    if user_emb.is_cuda:
        return _launch_wide(user_emb, item_emb, users, k, mask_indptr, mask_indices, sigmoid)
    _host_only(item_emb, users, mask_indptr, mask_indices)
    return masked_topk_reference(user_emb, item_emb, users, k, mask_indptr, mask_indices, sigmoid)


def masked_topk(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    users: torch.Tensor,
    k: int,
    mask_indptr: Optional[torch.Tensor] = None,
    mask_indices: Optional[torch.Tensor] = None,
    sigmoid: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores float32 [B, k], item ids int64 [B, k]) of the k best items of
    each row ``users[b]``; see the module docstring for the exact semantics.

    user_emb [N, d] and item_emb [M, d] float32; users [B] integer ids;
    mask_indptr [N + 1] / mask_indices int32: the train-positive CSR, rows
    sorted. CUDA tensors launch one kernel call: ``csrc/streaming_topk.cu`` for
    k <= ``MAX_K``, the radix select above; CPU tensors run the plain version.
    """
    _check(user_emb, item_emb, users, k, mask_indptr, mask_indices)
    if user_emb.is_cuda:
        launch = _launch if k <= MAX_K else _launch_wide
        return launch(user_emb, item_emb, users, k, mask_indptr, mask_indices, sigmoid)
    _host_only(item_emb, users, mask_indptr, mask_indices)
    return masked_topk_reference(
        user_emb, item_emb, users, k, mask_indptr, mask_indices, sigmoid
    )
