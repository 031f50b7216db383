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
(``RowShards``); a step that needs the whole table gathers it for its
forward (``RowShards.whole``), and the gather's backward hands the rank the
gradient of its own rows.
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
        """Sum ``x`` in place over ``axis`` (None: the whole world); returns x."""
        dist.all_reduce(x, group=None if axis is None else self.groups[axis])
        return x

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """[S, *x.shape]: every rank's ``x`` along ``axis``, in axis order."""
        buf = x.new_zeros((self.shape[axis],) + tuple(x.shape))
        buf[self.index(axis)] = x
        return self.all_reduce(buf, axis)

    def average(self, tensors: Sequence[torch.Tensor], axis: Optional[str] = DATA_AXIS) -> None:
        """Replace each tensor in place by its mean over ``axis`` (None: the
        whole world): one collective for each dtype."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        size = self.num_devices if axis is None else self.shape[axis]
        for ts in by_dtype.values():
            flat = self.all_reduce(torch.cat([t.reshape(-1) for t in ts]), axis)
            flat /= size
            for t, part in zip(ts, torch.split(flat, [t.numel() for t in ts])):
                t.copy_(part.view_as(t))

    def average_grads(self, params: Iterable[torch.Tensor], axis: Optional[str] = DATA_AXIS) -> None:
        """Average the gradients of ``params`` over ``axis`` (those that have
        one: the same ones on every rank, which run the same program)."""
        self.average([p.grad for p in params if p.grad is not None], axis)

    def broadcast_from_primary(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank (in place; as a sum with zeros)."""
        if self.rank != 0:
            x.zero_()
        return self.all_reduce(x)

    def barrier(self) -> None:
        """Wait for every rank (a one-element sum on the mesh's device)."""
        self.all_reduce(torch.zeros(1, device=self.device))


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


class _GatherRows(torch.autograd.Function):
    """The whole table from each model rank's block of rows; the backward
    keeps the rank's own rows of the gradient (every model rank of a data
    row runs the same forward, so the gradient is the same on each)."""

    @staticmethod
    def forward(ctx, shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.rows = shard.shape[0]
        ctx.lo = mesh.index(MODEL_AXIS) * shard.shape[0]
        return mesh.all_gather(shard.detach(), MODEL_AXIS).reshape((-1,) + tuple(shard.shape[1:]))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g[ctx.lo : ctx.lo + ctx.rows], None


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

    def span(self, name: str) -> Tuple[int, int]:
        """[lo, hi): this rank's rows of ``name``."""
        per = self.rows[name] // self.mesh.model
        lo = self.mesh.index(MODEL_AXIS) * per
        return lo, lo + per

    def average_grads(self, params: Iterable[torch.Tensor]) -> None:
        """Average the gradients of ``params``: a block's over ``data`` (the
        ranks that hold the same block), a replicated parameter's over the
        whole world. The model ranks of a data row compute the same step, up
        to the order of the card's atomic adds, so the world's mean is the
        data ranks' and keeps every replica equal."""
        params = list(params)
        blocks = {id(self.model.get_parameter(name)) for name in self.names}
        self.mesh.average_grads([p for p in params if id(p) in blocks], DATA_AXIS)
        self.mesh.average_grads([p for p in params if id(p) not in blocks], None)

    def own(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-table tensor of ``name``."""
        lo, hi = self.span(name)
        return full[lo:hi]

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole table from every model rank's ``block`` (no gradient);
        a collective over ``model``."""
        return self.mesh.all_gather(block.detach(), MODEL_AXIS).reshape((-1,) + tuple(block.shape[1:]))

    @contextlib.contextmanager
    def whole(self) -> Iterator[None]:
        """Inside, the model reads every sharded parameter as its whole table
        (gathered over ``model`` on entry, in ``names`` order on every rank),
        differentiable with respect to the rank's block; the blocks are put
        back on exit."""
        blocks = {}
        try:
            for name in self.names:
                owner, leaf = _owner(self.model, name)
                blocks[name] = owner._parameters[leaf]
                owner._parameters[leaf] = _GatherRows.apply(blocks[name], self.mesh)
            yield
        finally:
            for name, block in blocks.items():
                owner, leaf = _owner(self.model, name)
                owner._parameters[leaf] = block

    def release(self) -> None:
        """Put whole-size parameters back in place of the blocks (their
        values to be set by the caller: an init or a restore); no collective."""
        for name in self.names:
            owner, leaf = _owner(self.model, name)
            block = owner._parameters[leaf]
            owner._parameters[leaf] = nn.Parameter(
                block.new_empty((self.rows[name],) + tuple(block.shape[1:])))
        self.names = []


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
