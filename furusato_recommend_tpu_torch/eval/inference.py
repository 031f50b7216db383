"""Production inference (port of ``eval/inference.py``): a checkpoint's model
propagated once over the **inference edge set** (train + test interactions
for ``suffix == "all"`` or an ``inference{suffix}.txt``), then per target
batch of users a masked top-k that masks only the **train** positives, and
one CSV a batch (``eval.results.save_user_result``).

Each batch is one ``masked_topk`` call: the fused score + sigmoid + -1024
mask + top-k kernel on the card (one launch; above k = 128 the radix
select), its plain version on the CPU; ties go to the lower item id, as
``lax.top_k`` orders them. The
JAX package pads the last batch with user 0 to a whole batch and slices the
rows off; here it runs at its own size, which changes no row.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..convert import params_from_jax
from ..core.device import resolve_device
from ..data.dataset import Dataset
from ..models.base import PairwiseModel
from ..obs.log import step_timer
from ..ops.streaming_topk import MASK_SENTINEL, masked_topk
from .results import save_user_result

__all__ = ["production_inference", "MASK_SENTINEL"]


def production_inference(
    model: PairwiseModel,
    params: Optional[Mapping[str, Any]],
    dataset: Dataset,
    config: Config,
    out_dir,
    user_batch_size: int = 1000,
    target_batches: Sequence[int] = (0,),
    k: Optional[int] = None,
    product_names: Optional[np.ndarray] = None,
    customer_ids: Optional[np.ndarray] = None,
    device=None,
    sink=None,
) -> List[Path]:
    """Write ``{out_dir}/{model}_{latent_dim}_{n_layers}_{batch}_inference.csv``
    for each in-range batch index of ``target_batches`` (batch b holds users
    [b * user_batch_size, (b + 1) * user_batch_size)); returns their paths.

    ``params``: the JAX package's parameter dict (numpy), or None for the
    model's own. ``k`` defaults to config.max_topk. ``sink`` (a
    ``MetricLogger`` or any object with ``log``) takes the seconds of the
    graphs' build and copy to the device, the propagation, and each batch's
    top-k and CSV (``time/infer/...``)."""
    dev = resolve_device(device)
    model = model.to(dev)
    if params is not None:
        params_from_jax(params, model)
    kmax = int(k if k is not None else config.max_topk)
    with step_timer("infer/graph", sink, trace=True):
        mask = dataset.graph.user_pos.to(dev)  # the masking source: train positives only
        graph = dataset.inference_graph.to(dev)  # the propagation's: the inference edges
    with step_timer("infer/propagate", sink, trace=True), torch.no_grad():
        user_emb, item_emb = model.propagate(graph)
        user_emb = user_emb.detach().float().contiguous()
        item_emb = item_emb.detach().float().contiguous()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the propagation's time is its own, not the first batch's

    out_dir = Path(out_dir)
    paths: List[Path] = []
    for bi in target_batches:
        lo = bi * user_batch_size
        if lo >= dataset.n_users:
            print(f"[infer] batch {bi} out of range (n_users={dataset.n_users}); skipped")
            continue
        hi = min(lo + user_batch_size, dataset.n_users)
        users = np.arange(lo, hi, dtype=np.int64)
        with step_timer("infer/topk", sink, trace=True):
            _, ids = masked_topk(
                user_emb, item_emb, torch.from_numpy(users).to(dev), kmax, mask.indptr, mask.indices,
                sigmoid=model.score_sigmoid,
            )
            ids = ids.cpu().numpy()
        p = out_dir / f"{config.model}_{config.latent_dim}_{config.n_layers}_{bi}_inference.csv"
        with step_timer("infer/csv", sink, trace=True):
            save_user_result(
                p, dataset, users, ids, product_names=product_names, customer_ids=customer_ids, k=kmax,
            )
        paths.append(p)
        print(f"[infer] wrote {p} ({len(users)} users)")
    return paths
