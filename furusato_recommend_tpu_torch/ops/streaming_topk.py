"""Fused full-catalog score + train-positive mask + top-k (port of
``ops/pallas_topk.py::streaming_topk`` and of the masked top-k in
``serve.py::Recommender``).

``masked_topk`` is the serving path's kernel. For a CUDA tensor it launches the
hand-written kernel of ``csrc/streaming_topk.cu`` (two passes: blocks of 32
users x one item segment, then a merge per row; see the note in the source) or
raises. For CPU tensors it runs ``masked_topk_reference``, the plain PyTorch
version of the same function, which the CPU tests hold against the JAX
package.

Semantics, shared by both and by the JAX package:

- score float32 = <U[users[b]], I[j]>, then the sigmoid if asked;
- every j in the user's sorted train row (mask CSR) gets exactly -1024.0;
  masked items are not removed and still rank when fewer than k items remain;
- order: value descending, then item id ascending on ties (``lax.top_k``);
- ``k > M`` raises, as ``lax.top_k`` does. The kernel takes 1 <= k <= 128 and
  raises above that (a deviation: the plain version and the JAX package take
  any k <= M);
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

__all__ = ["masked_topk", "masked_topk_reference", "plan_tiles", "MASK_SENTINEL", "MAX_K"]

MASK_SENTINEL = -(1 << 10)
MAX_K = 128  # the kernel's shared-memory selection holds at most this many
MAX_DIM = 4096
USER_TILE = 32  # users per block, csrc/streaming_topk.cu kBU
ITEM_TILE = 128  # items per tile, kTI

#: kernel launches since the count was last set to 0 (one per masked_topk call
#: on CUDA tensors)
launches = 0


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
    the kernel clamps them (not as the JAX package treats negative ids; see
    the module docstring), the [B, M] score matrix, then a stable descending
    sort. On CUDA the product runs in full float32 (TF32 off for the call)."""
    _check(user_emb, item_emb, users, k, mask_indptr, mask_indices)
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
    # columns are item ids in ascending order, so a stable sort breaks value
    # ties by ascending id
    vals, ids = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), ids[:, :k].contiguous()


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


_ARGTYPES = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 6
    + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 4
)
_fn = None
_sm_count = {}  # device index -> SMs
_occupancy = {}  # (device index, k range, d <= 64) -> pass-1 blocks per SM


def _kernel():
    global _fn
    if _fn is None:
        fn = _cuda.library("streaming_topk").masked_topk_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _blocks_per_sm(idx: int, k: int, d: int) -> int:
    """Pass-1 blocks that one SM of device ``idx`` holds at once for this k
    and d, from the occupancy API; read once per device and instantiation."""
    key = (idx, (k > 32) + (k > 64), d <= 64)
    got = _occupancy.get(key)
    if got is None:
        fn = _cuda.library("streaming_topk").masked_topk_blocks_per_sm
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = fn(k, d, ctypes.byref(out))
        if err != 0 or out.value < 1:
            raise RuntimeError(f"masked_topk occupancy query failed: CUDA error {err}, "
                               f"{out.value} blocks per SM")
        got = _occupancy[key] = out.value
    return got


def _launch(user_emb, item_emb, users, k, mask_indptr, mask_indices, sigmoid):
    global launches
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
    m = item_emb.shape[0]
    b = users.shape[0]
    if k > MAX_K:
        raise ValueError(f"the CUDA kernel takes k <= {MAX_K}, got k={k}")
    if d > MAX_DIM:
        raise ValueError(f"the CUDA kernel takes d <= {MAX_DIM}, got d={d}")
    if m >= 2**31 - 1 or n >= 2**31:
        raise ValueError("the CUDA kernel takes int32 user and item ids")
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int64, device=dev)
    if b == 0:
        return out_v, out_i
    # ids are clamped into [0, N) on the device: no host check, no wait
    if users.dtype not in (torch.int32, torch.int64) or not users.is_contiguous():
        users = users.to(torch.int64).contiguous()
    idx = _cuda.device_index(dev)
    sms = _sm_count.get(idx)
    if sms is None:
        sms = _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    n_ut, n_seg, seg_len = plan_tiles(b, m, sms, _blocks_per_sm(idx, k, d))
    if n_ut > 65535:
        raise ValueError(f"the CUDA kernel takes at most {65535 * USER_TILE} users a call, got {b}")
    cand = torch.empty(2 * b * n_seg * k, dtype=torch.int32, device=dev)
    err = _cuda.launch(
        idx, _cuda.stream(idx), _kernel(),
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
    sorted. CUDA tensors launch the kernel; CPU tensors run the plain version.
    """
    _check(user_emb, item_emb, users, k, mask_indptr, mask_indices)
    if user_emb.is_cuda:
        return _launch(user_emb, item_emb, users, k, mask_indptr, mask_indices, sigmoid)
    tensors = [item_emb, users] + ([mask_indptr, mask_indices] if mask_indptr is not None else [])
    if any(t.is_cuda for t in tensors):
        raise ValueError("mixed CPU and CUDA tensors")
    return masked_topk_reference(
        user_emb, item_emb, users, k, mask_indptr, mask_indices, sigmoid
    )
