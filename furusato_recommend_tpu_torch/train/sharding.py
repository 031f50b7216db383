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
- the row-sharded tables (``core/mesh.py::shard_params``) are gathered for
  the forward, and their blocks take the gradient of their own rows.

``loss_backward`` and ``adam_step`` are a step's two halves, with or
without a mesh; ``Trainer`` runs every step of its cadences through them, and
``make_sharded_train_step`` returns (init_fn, step_fn) over them for one
model, as JAX's does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch

from ..config import Config
from ..core.distributed import local_rank
from ..core.mesh import DATA_AXIS, Mesh, RowShards, shard_params
from ..data.graph import BipartiteGraph
from ..models.base import PairwiseModel
from ..sampling.bpr import BPRBatch
from ..sampling.neighbor import SampledNeighbors

__all__ = [
    "shard_batch", "shard_draws", "loss_backward", "adam_step", "make_sharded_train_step", "build_kernels_once",
]


def shard_batch(batch: BPRBatch, mesh: Mesh) -> BPRBatch:
    """This data rank's rows of the whole ``batch`` (``BPRBatch.shard`` set)."""
    return batch.data_shard(mesh.index(DATA_AXIS), mesh.data)


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


def adam(params, config: Config) -> torch.optim.Adam:
    """``optax.adam(config.lr)``'s counterpart."""
    return torch.optim.Adam(params, lr=config.lr, betas=(0.9, 0.999), eps=1e-8)


def loss_backward(model: PairwiseModel, graph: BipartiteGraph, batch: BPRBatch,
                  generator: Optional[torch.Generator], draws: Optional[dict] = None,
                  shards: Optional[RowShards] = None, **kw) -> torch.Tensor:
    """Zero the gradients, then the loss on ``batch`` and its backward; the
    loss, detached. Under a mesh (``shards``) the loss is this data rank's
    share, on its rows of the whole batch and of the presampled ``draws``,
    with the row-sharded tables read whole."""
    model.zero_grad(set_to_none=True)
    if shards is not None:
        draws = shard_draws(draws, batch.user.shape[0], shards.mesh)
        batch = shard_batch(batch, shards.mesh)
    with shards.whole() if shards is not None else contextlib.nullcontext():
        loss, _ = model.loss(graph, batch, generator=generator, **(draws or {}), **kw)
        loss.backward()
    return loss.detach()


def adam_step(optimizer: torch.optim.Adam, shards: Optional[RowShards] = None) -> None:
    """One step of ``optimizer``; under a mesh its parameters' gradients are
    averaged first (``RowShards.average_grads``)."""
    if shards is not None:
        shards.average_grads(p for group in optimizer.param_groups for p in group["params"])
    optimizer.step()


def make_sharded_train_step(
    model: PairwiseModel, graph: BipartiteGraph, config: Config, mesh: Mesh
) -> Tuple[Callable, Callable]:
    """(init_fn, step_fn) of plain Adam steps over the mesh.

    init_fn(generator=None) -> (RowShards, Adam): the model's parameters
    (fresh ones drawn from ``generator`` when given) row-sharded in place,
    and a fresh Adam over them.

    step_fn(shards, optimizer, batch, generator=None, draws=None) -> the
    whole batch's loss: one forward and backward on this data rank's rows
    of the whole ``batch``, the gradients averaged over the mesh, one Adam
    step."""

    def init_fn(generator: Optional[torch.Generator] = None):
        if generator is not None:
            model.init_parameters(generator)
        shards = shard_params(model, mesh)
        return shards, adam(model.parameters(), config)

    def step_fn(shards: RowShards, optimizer: torch.optim.Adam, batch: BPRBatch,
                generator: Optional[torch.Generator] = None, draws: Optional[dict] = None) -> torch.Tensor:
        loss = loss_backward(model, graph, batch, generator, draws, shards)
        adam_step(optimizer, shards)
        return mesh.all_reduce(loss.reshape(1))[0] / mesh.num_devices

    return init_fn, step_fn
