"""Row scatter-add and the table gather whose backward it is (port of
``ops/pallas_scatter.py``: ``scatter_add_rows`` and ``table_gather``).

``scatter_add_rows(ids, rows, num_rows)`` is ``acc[ids[i]] += rows[i]`` into a
zeroed [num_rows, D] float32 table. For CUDA tensors it launches the
hand-written kernel of ``csrc/scatter_add_rows.cu`` (the table zeroed on the
stream, then one warp per update row, global atomic adds; see the note in the
source) or raises, for every call, no rows included, with no size below which
another path takes over; for CPU tensors it runs
``scatter_add_rows_reference``, the plain ``index_add_`` version.

``table_gather(table, ids)`` is ``table[ids]`` whose gradient goes through
``scatter_add_rows``: the MF / LightGCN losses gather every batch row through it,
so each training step's table gradients run the kernel. (The JAX package's
losses index the tables directly and take XLA's scatter-add as the gradient;
the gradients are the same.)

Ids outside [0, num_rows) are clamped into it by both versions, as the TPU
kernel's callers clip them; the wrapper never checks them on the host, so
it never waits for the card. The forward gather raises on such ids instead.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

__all__ = ["scatter_add_rows", "scatter_add_rows_reference", "table_gather"]

#: kernel launches since the count was last set to 0 (one per
#: scatter_add_rows call on CUDA tensors)
launches = 0


def _check(ids: torch.Tensor, rows: torch.Tensor, num_rows: int) -> None:
    if ids.dim() != 1 or rows.dim() != 2 or ids.shape[0] != rows.shape[0]:
        raise ValueError(
            f"need ids [R] and rows [R, D], got {tuple(ids.shape)} and {tuple(rows.shape)}"
        )
    if ids.dtype.is_floating_point or ids.dtype == torch.bool:
        raise ValueError(f"ids must be integers, got {ids.dtype}")
    if num_rows < 1 and rows.shape[0] > 0:
        raise ValueError(f"num_rows={num_rows}: no row to add into")


def scatter_add_rows_reference(
    ids: torch.Tensor, rows: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Plain PyTorch version of ``scatter_add_rows`` on any device."""
    _check(ids, rows, num_rows)
    out = torch.zeros((num_rows, rows.shape[1]), dtype=torch.float32, device=rows.device)
    if rows.shape[0]:
        out.index_add_(0, ids.long().clamp(0, num_rows - 1), rows.float())
    return out


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _cuda.library("scatter_add_rows").scatter_add_rows_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(ids: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    global launches
    dev = rows.device
    if ids.device != dev:
        raise ValueError(f"ids on {ids.device}, rows on {dev}")
    if rows.dtype != torch.float32 or not rows.is_contiguous():
        raise ValueError(f"rows must be contiguous float32, got {rows.dtype}")
    if num_rows >= 2**31:
        raise ValueError("the CUDA kernel takes int32 row ids")
    r, d = rows.shape
    if ids.dtype not in (torch.int32, torch.int64) or not ids.is_contiguous():
        ids = ids.to(torch.int64).contiguous()
    out = torch.empty((num_rows, d), dtype=torch.float32, device=dev)  # zeroed by the entry
    idx = _cuda.device_index(dev)
    err = _cuda.launch(
        idx, _cuda.stream(idx), _kernel(), ids.data_ptr(), int(ids.dtype == torch.int64),
        rows.data_ptr(), r, d, num_rows, out.data_ptr(),
    )
    if err != 0:
        raise RuntimeError(f"scatter_add_rows kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def scatter_add_rows(ids: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """sum_i onehot(ids[i]) outer rows[i] -> [num_rows, D] float32.

    ids [R] integer, rows [R, D] float32. CUDA tensors launch the kernel;
    CPU tensors run the plain version."""
    _check(ids, rows, num_rows)
    if rows.is_cuda:
        return _launch(ids, rows, num_rows)
    if ids.is_cuda:
        raise ValueError("mixed CPU and CUDA tensors")
    return scatter_add_rows_reference(ids, rows, num_rows)


class _TableGather(torch.autograd.Function):
    # the profiler ranges name the two directions for a trace's step breakdown
    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        with torch.profiler.record_function("table_gather"):
            flat = table.index_select(0, ids.reshape(-1))
        return flat.reshape(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (ids,) = ctx.saved_tensors
        d = g.shape[-1]
        with torch.profiler.record_function("scatter_add_rows"):
            rows = g.reshape(-1, d).to(torch.float32).contiguous()
            grad = scatter_add_rows(ids.reshape(-1), rows, ctx.num_rows)
        return grad.to(ctx.table_dtype), None


def table_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` ([*ids.shape, D]) whose gradient with respect to
    ``table`` is ``scatter_add_rows``. ids may have any shape."""
    return _TableGather.apply(table, ids)
