"""Training over the (data, model) mesh (port of ``train/sharding.py``).

The port's counterpart of the JAX package's pjit step, written out:

- every rank holds the whole batch (each draws the same epoch from the
  shared generator) and computes the loss on its data rank's rows
  (``shard_batch``); the randomness a step draws is drawn for the whole
  batch and cut to those rows (``sampling/bpr.py::draw_rows``), and
  presampled trees are cut the same way (``shard_draws``), so the mesh takes
  one process's draws;
- the loss divides by the whole batch's valid rows (``models/base.py::
  row_norm``), so the data ranks' mean loss and gradient are the whole
  batch's: before each Adam step a row-sharded block's gradient is averaged
  over ``data``, a replicated parameter's over the world (its model ranks
  compute the same, up to the order of atomic adds, and the world's mean
  keeps the replicas equal: ``RowShards.average_grads``);
- the row-sharded tables (``core/mesh.py::shard_params``) are gathered
  eagerly into the rank's whole-table buffers before the forward
  (``RowShards.gather_whole``) and read from them without a collective
  (``RowShards.read_whole``); their blocks take the gradient of their own
  rows;
- a loss that scores its rows against the whole batch's (in-batch InfoNCE)
  gathers the other data ranks' rows through the shard
  (``BatchShard.whole``), whose backward sums each row's gradient over
  ``data``.

A step is split at its collectives, with or without a mesh: the gather
(eager), ``loss_backward`` (the grad part: device work alone), the gradient
mean (``average_grads``, eager) and the Adam step (the update part: device
work alone); ``adam_step`` is the mean and the update in a row. ``Trainer``
runs every step of its cadences through this split, and a captured mesh
replays each device part as a CUDA graph with the collectives run eagerly
between them (``train/graphed.py``); ``make_sharded_train_step`` returns
(init_fn, step_fn) over it for one model, as JAX's does.
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Callable, Optional, Tuple

import torch

from ..config import Config
from ..core.distributed import local_rank
from ..core.mesh import DATA_AXIS, Mesh, RowShards, gather_data_rows, shard_params
from ..data.graph import BipartiteGraph
from ..models.base import PairwiseModel
from ..sampling.bpr import BPRBatch
from ..sampling.neighbor import SampledNeighbors

__all__ = [
    "shard_batch", "shard_draws", "loss_backward", "average_grads", "adam_step", "make_sharded_train_step",
    "build_kernels_once",
]


def shard_batch(batch: BPRBatch, mesh: Mesh) -> BPRBatch:
    """This data rank's rows of the whole ``batch`` (``BPRBatch.shard`` set,
    its rows gathered over ``data`` by ``gather_data_rows``)."""
    return batch.data_shard(mesh.index(DATA_AXIS), mesh.data, gather=partial(gather_data_rows, mesh=mesh))


def shard_draws(draws: Optional[dict], batch_size: int, mesh: Mesh) -> Optional[dict]:
    """A step's presampled draws (the loss's keyword arguments: lists of
    trees, each a list of ``SampledNeighbors`` levels whose leading axis is
    the batch's rows) cut to this data rank's rows."""
    if draws is None:
        return None
    per = batch_size // mesh.data
    mine = slice(mesh.index(DATA_AXIS) * per, (mesh.index(DATA_AXIS) + 1) * per)
    return {k: [[SampledNeighbors(*(x[mine] for x in lvl)) for lvl in tree] for tree in trees]
            for k, trees in draws.items()}


def build_kernels_once(mesh: Mesh) -> None:
    """Build the CUDA kernels on the host's first rank while the others wait
    (ranks of one host share the build directory)."""
    if mesh.device.type == "cuda":
        if local_rank() == 0:
            from ..ops import _cuda

            _cuda.build()
        mesh.barrier()


def adam(params, config: Config, capturable: bool = False) -> torch.optim.Adam:
    """``optax.adam(config.lr)``'s counterpart: torch's default Adam, or,
    where the steps are captured as CUDA graphs (``train/graphed.py``: every
    cadence on CUDA, a mesh's too, both Adams under T > 1), the fused Adam
    that a graph can record (one kernel a step for every parameter, its step
    counts on the card). Only the captured configurations take the fused
    one: it rounds its update otherwise than the default Adam, and where a
    SAGE step's ReLU input is within rounding of 0 that can turn the gate
    within a few steps and move parameters by a share of lr (the fresh
    cadence's run in ``tests/test_torch_cadence.py``, which holds the
    default Adam's steps to JAX's within rtol 1e-4, misses it under the fused
    one). The CPU, and a mesh's eager configurations (``core/graphs.py::
    gathers_over_data``), keep the default Adam for every cadence."""
    return torch.optim.Adam(params, lr=config.lr, betas=(0.9, 0.999), eps=1e-8,
                            **({"fused": True, "capturable": True} if capturable else {}))


def loss_backward(model: PairwiseModel, graph: BipartiteGraph, batch: BPRBatch,
                  generator: Optional[torch.Generator], draws: Optional[dict] = None,
                  shards: Optional[RowShards] = None, **kw) -> torch.Tensor:
    """The grad part of a step: zero the gradients, then the loss on
    ``batch`` and its backward; the loss, detached. Under a mesh
    (``shards``) the loss is this data rank's share, on its rows of the
    whole batch and of the presampled ``draws`` (views: static ones in a
    captured step), with the row-sharded tables read whole from the buffers
    that ``RowShards.gather_whole`` filled before it (no collective here,
    unless the loss gathers rows over ``data``)."""
    model.zero_grad(set_to_none=True)
    if shards is not None:
        draws = shard_draws(draws, batch.user.shape[0], shards.mesh)
        batch = shard_batch(batch, shards.mesh)
    with shards.read_whole() if shards is not None else contextlib.nullcontext():
        loss, _ = model.loss(graph, batch, generator=generator, **(draws or {}), **kw)
        loss.backward()
    return loss.detach()


def average_grads(optimizer: torch.optim.Adam, shards: Optional[RowShards] = None) -> None:
    """Under a mesh, the gradients of ``optimizer``'s parameters averaged in
    place (``RowShards.average_grads``: the collectives between a step's
    grad and update parts); nothing otherwise."""
    if shards is not None:
        shards.average_grads(p for group in optimizer.param_groups for p in group["params"])


def adam_step(optimizer: torch.optim.Adam, shards: Optional[RowShards] = None) -> None:
    """One step of ``optimizer`` (the update part); under a mesh its
    parameters' gradients are averaged first (``average_grads``)."""
    average_grads(optimizer, shards)
    optimizer.step()


def make_sharded_train_step(
    model: PairwiseModel, graph: BipartiteGraph, config: Config, mesh: Mesh
) -> Tuple[Callable, Callable]:
    """(init_fn, step_fn) of plain Adam steps over the mesh.

    init_fn(generator=None) -> (RowShards, Adam): the model's parameters
    (fresh ones drawn from ``generator`` when given) row-sharded in place,
    and a fresh Adam over them.

    step_fn(shards, optimizer, batch, generator=None, draws=None) -> the
    whole batch's loss: the tables gathered, one forward and backward on this
    data rank's rows of the whole ``batch``, the gradients averaged over the
    mesh, one Adam step (the split the Trainer's steps take)."""

    def init_fn(generator: Optional[torch.Generator] = None):
        if generator is not None:
            model.init_parameters(generator)
        shards = shard_params(model, mesh)
        return shards, adam(model.parameters(), config)

    def step_fn(shards: RowShards, optimizer: torch.optim.Adam, batch: BPRBatch,
                generator: Optional[torch.Generator] = None, draws: Optional[dict] = None) -> torch.Tensor:
        shards.gather_whole()
        loss = loss_backward(model, graph, batch, generator, draws, shards)
        adam_step(optimizer, shards)
        return mesh.all_reduce(loss.reshape(1))[0] / mesh.num_devices

    return init_fn, step_fn
