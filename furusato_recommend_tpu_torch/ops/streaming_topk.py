"""Fused full-catalog score + train-positive mask + top-k (port of
``ops/pallas_topk.py::streaming_topk`` and of the masked top-k in
``serve.py::Recommender``).

``masked_topk`` is the serving path's kernel. For a CUDA tensor it launches the
hand-written kernel of ``csrc/streaming_topk.cu`` (two passes: per item segment,
then a merge per row; see the note in the source) or raises. For CPU tensors it
runs ``masked_topk_reference``, the plain PyTorch version of the same function,
which the CPU tests hold against the JAX package.

Semantics, shared by both and by the JAX package:

- score float32 = <U[users[b]], I[j]>, then the sigmoid if asked;
- every j in the user's sorted train row (mask CSR) gets exactly -1024.0;
  masked items are not removed and still rank when fewer than k items remain;
- order: value descending, then item id ascending on ties (``lax.top_k``);
- ``k > M`` raises, as ``lax.top_k`` does. The kernel takes 1 <= k <= 128 and
  raises above that (a deviation: the plain version and the JAX package take
  any k <= M).

Scores that are NaN have no defined rank.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..data.graph import CSR
from . import _cuda
from .csr_search import csr_gather_padded

__all__ = ["masked_topk", "masked_topk_reference", "plan_segments", "MASK_SENTINEL", "MAX_K"]

MASK_SENTINEL = -(1 << 10)
MAX_K = 128  # the kernel's shared-memory selection holds at most this many
MAX_DIM = 4096  # the user row is staged in shared memory
_THREADS = 256  # threads per block, csrc/streaming_topk.cu kThreads

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
    """Plain PyTorch version of ``masked_topk``: the [B, M] score matrix, then
    a stable descending sort. On CUDA the product runs in full float32
    (TF32 off for the call)."""
    _check(user_emb, item_emb, users, k, mask_indptr, mask_indices)
    users = users.long()
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


def plan_segments(n_rows: int, m_items: int, k: int, sm_count: int) -> Tuple[int, int]:
    """(segments per row, items per segment) for pass 1: enough blocks for two
    per SM when the request has few rows, each segment at least
    max(256, 4k) items so that pass 2 merges few candidates."""
    min_len = max(_THREADS, 4 * k)
    want = -(-2 * sm_count // max(n_rows, 1))
    n_seg = max(1, min(want, m_items // min_len))
    seg_len = -(-m_items // n_seg)
    return -(-m_items // seg_len), seg_len


_ARGTYPES = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 5
)


def _kernel():
    fn = _cuda.library("streaming_topk").masked_topk_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


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
    lo, hi = torch.aminmax(users)
    if int(lo) < 0 or int(hi) >= n:
        raise ValueError(f"user ids must be in [0, {n}), got [{int(lo)}, {int(hi)}]")
    users32 = users.to(torch.int32).contiguous()
    props = torch.cuda.get_device_properties(dev)
    n_seg, seg_len = plan_segments(b, m, k, props.multi_processor_count)
    if n_seg > 65535:
        raise ValueError(f"catalog of {m} items needs {n_seg} segments, more than 65535")
    cand_v = torch.empty((b, n_seg, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((b, n_seg, k), dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            user_emb.data_ptr(), item_emb.data_ptr(), users32.data_ptr(),
            b, m, d, k,
            None if mask_indptr is None else mask_indptr.data_ptr(),
            None if mask_indices is None else mask_indices.data_ptr(),
            int(bool(sigmoid)), n_seg, seg_len,
            cand_v.data_ptr(), cand_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
            stream,
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
