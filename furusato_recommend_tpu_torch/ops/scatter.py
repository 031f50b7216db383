"""Row scatter-add and the table gather whose backward it is (port of
``ops/pallas_scatter.py``: ``scatter_add_rows`` and ``table_gather``).

``scatter_add_rows(ids, rows, num_rows)`` is ``acc[ids[i]] += rows[i]`` into a
zeroed [num_rows, D] float32 table. For CUDA tensors it launches the
hand-written kernel of ``csrc/scatter_add_rows.cu`` or raises, for every call,
no rows included, with no size below which another path takes over; for CPU
tensors it runs ``scatter_add_rows_reference``, the plain ``index_add_``
version.

The kernel has two modes, and ``plan_scatter(n, r, d, sm_count)`` picks one
from the shapes alone (it never reads the ids, so it adds no host sync; see the
note in the source):

- ``tile``: tiles of T consecutive rows (T a multiple of 32), one persistent
  block per tile where the card holds them; the block sorts the tile's rows by
  id through a hash in shared memory, sums each id's rows in registers and
  adds each distinct id into the table once (a hub item's chain of adds falls
  from one a row to one a tile); wide D goes in column chunks;
- ``row``: one warp per update row, one global add per element; taken where
  tiles would be shorter than ``ROW_BELOW_TILE`` rows and the row mode's chains
  stay short (R < ``ROW_CHAIN`` x N): the LightGCN steps' gathers.

``table_gather(table, ids)`` is ``table[ids]`` whose gradient goes through
``scatter_add_rows``: the MF / LightGCN losses gather every batch row through it
(4 launches a step), and the SAGE family gathers every level of a step's fanout
trees, one call per side, and its categorical (``c``) feature columns through
it (``models/sage.py``). (The JAX package's losses index the tables directly
and take XLA's scatter-add as the gradient; the gradients are the same.)

Ids outside [0, num_rows) are clamped into it by both versions of the
scatter, and ``table_gather`` clamps its ids once, on the device, for both
directions: the forward reads the clamped row and the gradient adds into it.
Nothing checks ids on the host, so nothing waits for the card. (Deviation: the
JAX package's ``table[ids]`` wraps ids in [-N, 0) once and clips the rest, and
its gradient drops the rows of ids that are out of range after the wrap.)
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _cuda

__all__ = [
    "ScatterPlan", "count_replay", "plan_scatter", "scatter_add_rows", "scatter_add_rows_reference",
    "table_gather",
]

#: kernel launches since the count was last set to 0 (one per
#: scatter_add_rows call on CUDA tensors, and those of every replay of a CUDA
#: graph that recorded them: ``count_replay``)
launches = 0
#: launches recorded into CUDA graphs being captured, which execute nothing
#: (a capture's count is the difference across it)
captured = 0

MODES = {"row": 0, "tile": 1}  # csrc/scatter_add_rows.cu Mode
THREADS = 256  # threads a block, kThreads
ROW_WARPS = THREADS // 32  # rows a row-mode block takes at a time
MAX_TILE = 2048  # kMaxTile
SMEM_PER_SM = 233_472  # 228 KB of shared memory an SM gives its blocks (H100)
SMEM_PER_BLOCK = 232_448  # 227 KB, a block's most
SMEM_RESERVED = 1024 + 128  # the system's 1 KB a block, and the kernel's static bytes
TILE_BLOCKS_PER_SM = 2  # the tile kernel's __launch_bounds__
TILE_BYTES = SMEM_PER_SM // TILE_BLOCKS_PER_SM - SMEM_RESERVED
TILE_OVERHEAD_ROWS = 64  # a tile's id pass and barriers, in rows' worth of time
ROW_BELOW_TILE = 128  # row mode where the tiles would be shorter than this,
ROW_CHAIN = 64  # and R < ROW_CHAIN x N: the row mode's chains of adds into one address stay short


class ScatterPlan(NamedTuple):
    mode: str  # "row" or "tile"
    tile: int  # rows a block takes at a time (row mode: one a warp)
    tiles: int  # ceil(R / tile)
    blocks: int  # the grid
    chunk: int  # columns a pass over the sorted rows takes (tile mode), else D
    smem_bytes: int  # dynamic shared memory a block


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _groups(width: int, vw: int) -> int:
    """Lane groups of a block (``kThreads / group_of`` in the source): as many
    lanes a group as a row of ``width`` floats has ``vw``-float vectors, rounded
    up to a power of two, at most 32."""
    nv, g = width // vw, 32
    while g > 1 and g // 2 >= nv:
        g //= 2
    return THREADS // g


def tile_smem(tile: int, chunk: int, vw: int) -> int:
    """Dynamic shared memory of a tile-mode block (``tile_smem`` in the
    source): a head and a tail piece of ``chunk`` floats and their entries for
    each lane group, the hash's 2 x tile keys and counts and 7 x tile ints of
    per-row and per-entry indices."""
    groups = _groups(chunk, vw)
    return 4 * (2 * groups * chunk + 2 * groups + 11 * tile)


def _tile_plan(r: int, d: int, sm_count: int) -> ScatterPlan:
    slots = TILE_BLOCKS_PER_SM * sm_count
    best = None
    for t in range(32, MAX_TILE + 1, 32):
        tiles = _ceil(r, t)
        cost = _ceil(tiles, slots) * (t + TILE_OVERHEAD_ROWS)  # waves x a block's rows
        if best is None or cost < best[0]:
            best = (cost, t)
        if tiles <= slots:  # one wave: a longer tile only takes longer
            break
    t = best[1]
    vw = 4 if d % 4 == 0 else 1  # float4 columns stay aligned in every chunk
    chunks = 1
    while True:
        chunk = _ceil(_ceil(max(d, 1), chunks), vw) * vw
        if tile_smem(t, chunk, vw) <= TILE_BYTES:
            break
        chunks += 1
    tiles = _ceil(r, t)
    return ScatterPlan("tile", t, tiles, max(1, min(tiles, slots)), chunk, tile_smem(t, chunk, vw))


@functools.lru_cache(maxsize=1024)
def plan_scatter(n: int, r: int, d: int, sm_count: int, mode: Optional[str] = None) -> ScatterPlan:
    """The kernel's launch plan for an [n, d] table and r update rows on a card
    of ``sm_count`` SMs, from these shapes only. ``mode`` forces a mode (for
    measurements and tests); by default tile mode, or row mode where the tiles
    would be shorter than ``ROW_BELOW_TILE`` rows and r < ``ROW_CHAIN`` x n."""
    if mode is None:
        plan = _tile_plan(r, d, sm_count)
        if plan.tile >= ROW_BELOW_TILE or r >= ROW_CHAIN * n:
            return plan
        mode = "row"
    if mode == "tile":
        return _tile_plan(r, d, sm_count)
    if mode == "row":
        tiles = _ceil(r, ROW_WARPS)
        return ScatterPlan("row", ROW_WARPS, tiles, max(1, min(tiles, 32 * sm_count)), d, 0)
    raise ValueError(f"unknown mode {mode!r}")


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
_sm_count = {}  # device index -> SMs
_prepared = set()  # (device index, mode) whose shared-memory limit is raised


def _kernel():
    global _fn
    if _fn is None:
        fn = _cuda.library("scatter_add_rows").scatter_add_rows_launch
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
            + [ctypes.c_int] * 8 + [ctypes.c_void_p, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _prepare(idx: int, mode: str) -> None:
    """Raise the mode's shared-memory limit on device ``idx``, once."""
    if (idx, mode) in _prepared:
        return
    fn = _cuda.library("scatter_add_rows").scatter_add_rows_prepare
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    with torch.cuda.device(idx):
        err = fn(MODES[mode])
    if err != 0:
        raise RuntimeError(f"scatter_add_rows {mode} mode setup failed: CUDA error {err}")
    _prepared.add((idx, mode))


def sm_count(idx: int) -> int:
    """SMs of device ``idx``, read once."""
    sms = _sm_count.get(idx)
    if sms is None:
        sms = _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return sms


def _launch(ids: torch.Tensor, rows: torch.Tensor, num_rows: int,
            plan: Optional[ScatterPlan] = None) -> torch.Tensor:
    """The kernel on CUDA tensors, under ``plan`` (default ``plan_scatter``'s;
    measurements force another mode through it)."""
    global launches, captured
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
    idx = _cuda.device_index(dev)
    if plan is None:
        plan = plan_scatter(num_rows, r, d, sm_count(idx))
    _prepare(idx, plan.mode)
    vec4 = d % 4 == 0 and rows.data_ptr() % 16 == 0  # the table is allocated aligned
    out = torch.empty((num_rows, d), dtype=torch.float32, device=dev)  # zeroed by the entry
    err = _cuda.launch(
        idx, _cuda.stream(idx), _kernel(), ids.data_ptr(), int(ids.dtype == torch.int64),
        rows.data_ptr(), r, d, num_rows, MODES[plan.mode], plan.tile, plan.blocks, plan.chunk,
        plan.smem_bytes, int(vec4), out.data_ptr(),
    )
    if err != 0:
        raise RuntimeError(f"scatter_add_rows kernel launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out


def count_replay(n: int) -> None:
    """Count the ``n`` launches a replayed CUDA graph's capture recorded."""
    global launches
    launches += n


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
        ctx.num_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        with torch.profiler.record_function("table_gather"):
            flat_ids = ids.reshape(-1).clamp(0, table.shape[0] - 1)
            flat = table.index_select(0, flat_ids)
        ctx.save_for_backward(flat_ids)
        return flat.reshape(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (flat_ids,) = ctx.saved_tensors
        d = g.shape[-1]
        with torch.profiler.record_function("scatter_add_rows"):
            rows = g.reshape(-1, d).to(torch.float32).contiguous()
            grad = scatter_add_rows(flat_ids, rows, ctx.num_rows)
        return grad.to(ctx.table_dtype), None


def table_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids.clamp(0, N - 1)]`` ([*ids.shape, D]) whose gradient with
    respect to ``table`` is ``scatter_add_rows`` of the same clamped ids. ids
    may have any shape."""
    return _TableGather.apply(table, ids)
