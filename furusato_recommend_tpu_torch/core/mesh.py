"""The (data, model) device mesh over ``torch.distributed`` (port of
``core/mesh.py``).

A mesh of ``data`` x ``model`` ranks lays the world out as the JAX package
reshapes its devices: rank r sits at ``(r // model, r % model)``. The
``data`` axis splits the training batch and the evaluation's users (the
reference's DDP); the ``model`` axis row-splits the large parameter tables
and the evaluation's catalog. Each axis has one process group a row or
column of the mesh, and every collective of the port runs through
``Mesh.all_reduce`` (a sum): an all-gather is the sum of a zeroed [S, ...]
buffer in which each rank fills its own slot (the JAX package's psum form),
which NCCL and gloo take alike, on CUDA tensors too.

``shard_params`` keeps the JAX placement rule: a parameter is row-sharded
over ``model`` when it is at least 2-D, has at least ``min_rows`` rows and
its rows divide by the model size; everything else is replicated. A sharded
parameter and its Adam moments live as the rank's 1/model block of rows
(``RowShards``). A step that needs the whole table reads it in two halves:
an eager gather (``RowShards.gather_whole``) writes every table, in place,
into a whole-table buffer the rank keeps, and inside ``read_whole`` the model
reads those buffers through a collective-free autograd function whose
backward hands the rank the gradient of its own rows. ``whole`` is the two
in a row.

Where the collectives run relative to the CUDA graphs: on a CUDA device a
mesh's training steps and evaluations are captured in parts
(``train/graphed.py``, ``eval/graphed.py``), each part device work alone,
and every collective (the whole-table gather, the gradient mean,
``Mesh.average``'s flat buffer, the evaluation's candidates and sums) runs
eagerly between the parts, through gloo or NCCL alike. ``Mesh.all_reduce``
raises if it is reached while the current stream is capturing, so a
collective that slips into a capture fails loudly.

``gather_data_rows`` is the batch's counterpart over ``data``: a loss that
scores a data rank's rows against the whole batch's (in-batch InfoNCE)
gathers the other ranks' rows, and its backward sums the gradient of each
row over the data ranks before the rank keeps its own rows.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "sharded_names", "shard_params", "RowShards",
    "gather_data_rows",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"
MIN_ROWS = 1024


@dataclass(eq=False)
class Mesh:
    """This rank's place on a (data, model) mesh and the two groups it is
    in; ``shape`` is {axis: size} as in JAX."""

    data: int
    model: int
    rank: int
    device: torch.device
    groups: Dict[str, object] = field(repr=False)
    #: the collectives this rank has run (``all_reduce`` calls)
    collectives: int = field(default=0, repr=False)
    #: ``average``'s flat buffers, by (dtype, axis, elements, device)
    _flat: Dict[tuple, torch.Tensor] = field(default_factory=dict, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def num_devices(self) -> int:
        return self.data * self.model

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.rank // self.model if axis == DATA_AXIS else self.rank % self.model

    def all_reduce(self, x: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """Sum ``x`` in place over ``axis`` (None: the whole world); returns x.
        Raises while the current CUDA stream is capturing: a capture cannot
        record a gloo collective, and a mesh's graphs hold device work alone."""
        if capturing():
            raise RuntimeError("a mesh collective was reached inside a CUDA graph capture; the mesh's "
                               "collectives run eagerly between its captured parts")
        dist.all_reduce(x, group=None if axis is None else self.groups[axis])
        self.collectives += 1
        return x

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """[S, *x.shape]: every rank's ``x`` along ``axis``, in axis order."""
        buf = x.new_zeros((self.shape[axis],) + tuple(x.shape))
        buf[self.index(axis)] = x
        return self.all_reduce(buf, axis)

    def average(self, tensors: Sequence[torch.Tensor], axis: Optional[str] = DATA_AXIS) -> None:
        """Replace each tensor in place by its mean over ``axis`` (None: the
        whole world): one collective for each dtype, through a flat buffer
        kept for that dtype, axis and size (allocated at the first call)."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        size = self.num_devices if axis is None else self.shape[axis]
        for dtype, ts in by_dtype.items():
            sizes = [t.numel() for t in ts]
            key = (dtype, axis, sum(sizes), ts[0].device)
            if key not in self._flat:
                self._flat[key] = torch.empty(sum(sizes), dtype=dtype, device=ts[0].device)
            flat = self._flat[key]
            torch.cat([t.reshape(-1) for t in ts], out=flat)
            self.all_reduce(flat, axis)
            flat /= size
            for t, part in zip(ts, torch.split(flat, sizes)):
                t.copy_(part.view_as(t))

    def broadcast_from_primary(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank (in place; as a sum with zeros)."""
        if self.rank != 0:
            x.zero_()
        return self.all_reduce(x)

    def barrier(self) -> None:
        """Wait for every rank (a one-element sum on the mesh's device)."""
        self.all_reduce(torch.zeros(1, device=self.device))


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def make_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """The (data, model) mesh over the initialised world, whose size must be
    data x model. Every rank creates every group, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"a ({data}, {model}) mesh needs a world of {data * model} processes: call "
            "core.distributed.initialize_multihost first (or launch with torchrun)"
        )
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"mesh ({data}, {model}) needs {data * model} ranks, the world has {world}")
    rank = dist.get_rank()
    groups: Dict[str, object] = {}
    for d in range(data):  # the model group of each row
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            groups[MODEL_AXIS] = g
    for m in range(model):  # the data group of each column
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            groups[DATA_AXIS] = g
    return Mesh(data, model, rank, torch.device("cpu" if device is None else device), groups)


def sharded_names(shapes: Mapping[str, Tuple[int, ...]], model_size: int, min_rows: int = MIN_ROWS) -> List[str]:
    """The names whose shape the JAX placement rule row-shards over a model
    axis of ``model_size``: ndim >= 2, rows >= ``min_rows``, rows divisible."""
    return sorted(
        name for name, shape in shapes.items()
        if len(shape) >= 2 and shape[0] >= min_rows and shape[0] % model_size == 0
    )


class _ReadWhole(torch.autograd.Function):
    """The whole table, read from the buffer the eager gather filled
    (``RowShards.gather_whole``), as a function of the rank's block of rows:
    no collective. The backward keeps the rank's own rows of the gradient
    (every model rank of a data row runs the same forward, so the gradient
    is the same on each)."""

    @staticmethod
    def forward(ctx, block: torch.Tensor, whole: torch.Tensor, lo: int) -> torch.Tensor:
        ctx.rows, ctx.lo = block.shape[0], lo
        return whole.view_as(whole)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g[ctx.lo : ctx.lo + ctx.rows], None, None


class _GatherData(torch.autograd.Function):
    """The whole batch's rows from each data rank's share of them. Unlike
    ``_ReadWhole``, the backward sums the cotangent over ``data`` before it
    keeps the rank's rows: data rank r's loss scores its own rows against
    every rank's, so the gradient that r's loss sends to rank s's rows
    exists on r alone, and keeping only the rank's own slice would drop
    every cross-rank term (the world average of the gradients that follows
    cannot bring them back)."""

    @staticmethod
    def forward(ctx, rows: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.rows, ctx.mesh = rows.shape[0], mesh
        ctx.lo = mesh.index(DATA_AXIS) * rows.shape[0]
        return mesh.all_gather(rows.detach(), DATA_AXIS).reshape((-1,) + tuple(rows.shape[1:]))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = ctx.mesh.all_reduce(g.clone(memory_format=torch.contiguous_format), DATA_AXIS)
        return g[ctx.lo : ctx.lo + ctx.rows], None


def gather_data_rows(rows: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[data x n, ...]: every data rank's [n, ...] ``rows`` in rank order (a
    collective over ``data``), differentiable with respect to this rank's;
    its backward sums the gradient over ``data`` (``_GatherData``). A data
    axis of 1 returns ``rows``: no collective."""
    return rows if mesh.data == 1 else _GatherData.apply(rows, mesh)


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    prefix, _, leaf = name.rpartition(".")
    return (model.get_submodule(prefix) if prefix else model), leaf


class RowShards:
    """The row-sharded parameters of ``model`` on ``mesh``: each is an
    ``nn.Parameter`` holding this rank's block of ``rows[name] / model``
    rows, under its own name, so that optimizers and moments see only the
    block."""

    def __init__(self, model: nn.Module, mesh: Mesh, names: Sequence[str], rows: Mapping[str, int]):
        self.model, self.mesh = model, mesh
        self.names = list(names)
        self.rows = dict(rows)
        #: name -> the whole table, filled in place by ``gather_whole``
        #: (allocated at its first call); what ``read_whole`` reads
        self.tables: Dict[str, torch.Tensor] = {}

    def span(self, name: str) -> Tuple[int, int]:
        """[lo, hi): this rank's rows of ``name``."""
        per = self.rows[name] // self.mesh.model
        lo = self.mesh.index(MODEL_AXIS) * per
        return lo, lo + per

    def grad_groups(self, params: Iterable[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(the blocks' gradients, the replicated parameters' gradients) of
        ``params``, those that have one: what ``average`` averages. A
        captured step keeps the tensors its capture wrote."""
        blocks = {id(self.model.get_parameter(name)) for name in self.names}
        params = [p for p in params if p.grad is not None]
        return [p.grad for p in params if id(p) in blocks], [p.grad for p in params if id(p) not in blocks]

    def average(self, groups: Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]) -> None:
        """Average ``grad_groups``' gradients in place: a block's over
        ``data`` (the ranks that hold the same block), a replicated
        parameter's over the whole world. The model ranks of a data row
        compute the same step, up to the order of the card's atomic adds, so
        the world's mean is the data ranks' and keeps every replica equal."""
        blocks, replicated = groups
        if blocks:
            self.mesh.average(blocks, DATA_AXIS)
        if replicated:
            self.mesh.average(replicated, None)

    def average_grads(self, params: Iterable[torch.Tensor]) -> None:
        """Average the gradients of ``params`` (``average``)."""
        self.average(self.grad_groups(params))

    def own(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-table tensor of ``name``."""
        lo, hi = self.span(name)
        return full[lo:hi]

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole table from every model rank's ``block`` (no gradient);
        a collective over ``model``."""
        return self.mesh.all_gather(block.detach(), MODEL_AXIS).reshape((-1,) + tuple(block.shape[1:]))

    @torch.no_grad()
    def gather_whole(self) -> None:
        """Write every sharded table whole into its buffer in ``tables``, in
        place (a collective over ``model`` a table, in ``names`` order on
        every rank): the buffer zeroed, the rank's block copied into its
        rows, then summed over ``model``."""
        for name in self.names:
            block = self.model.get_parameter(name)
            if name not in self.tables:
                self.tables[name] = block.new_empty((self.rows[name],) + tuple(block.shape[1:]))
            whole = self.tables[name]
            lo, hi = self.span(name)
            whole.zero_()
            whole[lo:hi].copy_(block)
            self.mesh.all_reduce(whole, MODEL_AXIS)

    @contextlib.contextmanager
    def read_whole(self) -> Iterator[None]:
        """Inside, the model reads every sharded parameter as its whole table
        from ``tables`` (``gather_whole`` fills them; no collective),
        differentiable with respect to the rank's block; the blocks are put
        back on exit."""
        blocks = {}
        try:
            for name in self.names:
                owner, leaf = _owner(self.model, name)
                blocks[name] = owner._parameters[leaf]
                owner._parameters[leaf] = _ReadWhole.apply(blocks[name], self.tables[name], self.span(name)[0])
            yield
        finally:
            for name, block in blocks.items():
                owner, leaf = _owner(self.model, name)
                owner._parameters[leaf] = block

    @contextlib.contextmanager
    def whole(self) -> Iterator[None]:
        """``gather_whole`` on entry, then ``read_whole``."""
        self.gather_whole()
        with self.read_whole():
            yield

    def release(self) -> None:
        """Put whole-size parameters back in place of the blocks (their
        values to be set by the caller: an init or a restore); no collective."""
        for name in self.names:
            owner, leaf = _owner(self.model, name)
            block = owner._parameters[leaf]
            owner._parameters[leaf] = nn.Parameter(
                block.new_empty((self.rows[name],) + tuple(block.shape[1:])))
        self.names, self.tables = [], {}


def shard_params(model: nn.Module, mesh: Mesh, min_rows: int = MIN_ROWS) -> RowShards:
    """Row-shard ``model``'s parameters in place under the JAX placement rule
    (``sharded_names``); a model axis of 1 shards nothing. Each sharded
    parameter becomes this rank's block of its rows."""
    params = dict(model.named_parameters())
    names = sharded_names({k: tuple(p.shape) for k, p in params.items()}, mesh.model, min_rows) \
        if mesh.model > 1 else []
    rows = {name: params[name].shape[0] for name in names}
    shards = RowShards(model, mesh, names, rows)
    for name in names:
        owner, leaf = _owner(model, name)
        lo, hi = shards.span(name)
        owner._parameters[leaf] = nn.Parameter(params[name].detach()[lo:hi].clone())
    return shards
