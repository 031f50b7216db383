"""Full-catalog evaluation: propagate once, then per user tile score -> mask
train positives -> top-K -> metric sums (port of ``eval/evaluate.py``).

Each tile's score + mask + top-K is one ``ops/streaming_topk.py::masked_topk``
call (the fused CUDA kernel on the card, its plain version on the CPU): train
positives score exactly -1024, the sentinel of the JAX package, and ties go to
the lower item id, as ``lax.top_k`` orders them. Metric sums and the
coverage bitmap accumulate on the device; one copy to the host per evaluation.

Metrics are divided by the number of test users; coverage is corpus-level;
``cold_*`` metrics cover users with id < 10000 when ``config.cold_start``.
``config.compute_auc`` scores the full [B, M] matrix per tile with
``torch.matmul`` (off the main path, as the JAX package leaves it to XLA).
``--inference sample`` encodes every entity through its sampled fanout tree
(``propagate_sampled``, drawn from a generator seeded with config.seed) for
the models that have it, the SAGE family; the others propagate as usual.

Under a (data, model) mesh every rank propagates (``--inference sample``
splits its seeds over ``data``), then each tile's users are split over
``data`` and scored through ``eval/sharded.py::sharded_masked_topk`` against
the rank's block of the catalog (one ``masked_topk`` launch a tile on every
rank); every rank runs every tile, so the collectives line up. The metric
sums and the coverage are summed over the data group only (the model ranks
hold the same numbers), then every rank takes rank 0's, so that every rank
decides alike on them; the top-K ids are gathered over ``data``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..core.mesh import DATA_AXIS
from ..data.dataset import Dataset
from ..data.graph import BipartiteGraph
from ..models.base import PairwiseModel
from ..ops.csr_search import csr_gather_padded
from ..ops.streaming_topk import masked_topk
from .metrics import batch_auc_sum, batch_metric_sums, unexpectedness_from_pmi
from .sharded import item_block, local_mask, sharded_masked_topk

__all__ = ["EvalData", "build_eval_data", "Evaluator", "MASK_SENTINEL", "COLD_START_UID"]

MASK_SENTINEL = -(1 << 10)
COLD_START_UID = 10000


@dataclass(frozen=True)
class EvalData:
    """Evaluation inputs, built on the host once per dataset."""

    users: torch.Tensor  # [nb, B] int32 test users, zero padded
    valid: torch.Tensor  # [nb, B] bool
    item_categories: Optional[torch.Tensor]  # [M, C] int32, -1 padded
    item_popularity: Optional[torch.Tensor]  # [M] float32 occurrences / n_users


def build_eval_data(
    dataset: Dataset,
    batch_size: int,
    item_categories: Optional[np.ndarray] = None,
    max_batches: Optional[int] = None,
    device=None,
) -> EvalData:
    test_users = np.unique(dataset.test_user).astype(np.int32)
    if max_batches is not None:
        test_users = test_users[: max_batches * batch_size]
    n = len(test_users)
    nb = max(1, -(-n // batch_size))
    pad = nb * batch_size - n
    users = np.concatenate([test_users, np.zeros(pad, dtype=np.int32)])
    valid = np.concatenate([np.ones(n, dtype=bool), np.zeros(pad, dtype=bool)])
    pop = dataset.item_occurrence().astype(np.float32) / dataset.n_users
    return EvalData(
        users=torch.from_numpy(users.reshape(nb, batch_size)).to(device),
        valid=torch.from_numpy(valid.reshape(nb, batch_size)).to(device),
        item_categories=None
        if item_categories is None
        else torch.as_tensor(np.asarray(item_categories), dtype=torch.int32).to(device),
        item_popularity=torch.from_numpy(pop).to(device),
    )


class Evaluator:
    """Full-catalog evaluator of ``model`` on ``graph`` (its train positives
    are the mask, its test positives the relevant items)."""

    def __init__(
        self,
        model: PairwiseModel,
        graph: BipartiteGraph,
        config: Config,
        max_train_degree: int,
        mesh=None,
    ):
        if mesh is not None and config.compute_auc:
            raise ValueError("compute_auc needs full [B, M] scores; unsupported under a mesh")
        if mesh is not None and config.inference == "sample" and config.sample_infer_chunk % mesh.data:
            raise ValueError(
                f"--inference sample under a mesh needs sample_infer_chunk ({config.sample_infer_chunk}) "
                f"divisible by the mesh data axis ({mesh.data})"
            )
        self.mesh = mesh
        self._local_mask = None  # the rank's block of the train mask (mesh), built once
        self.model = model
        self.config = config
        self.topks = tuple(config.topks)
        self.kmax = max(self.topks)
        self.max_train_degree = int(max_train_degree)
        self.graph = graph

    @torch.no_grad()
    def embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (user, item) embeddings the evaluation scores with."""
        if self.config.inference == "sample" and hasattr(self.model, "propagate_sampled"):
            gen = torch.Generator(device=self.graph.user_pos.indptr.device)
            gen.manual_seed(self.config.seed)
            if self.mesh is not None:
                return self.model.propagate_sampled(self.graph, gen, mesh=self.mesh)
            return self.model.propagate_sampled(self.graph, gen)
        return self.model.propagate(self.graph)

    def _scores(self, user_emb, item_emb, users) -> torch.Tensor:
        """The full [B, M] masked score matrix (for AUC)."""
        s = (user_emb[users.long()] @ item_emb.T).float()
        if self.model.score_sigmoid:
            s = torch.sigmoid(s)
        pos, mask = csr_gather_padded(self.graph.user_pos, users, self.max_train_degree)
        rows = torch.arange(users.shape[0], device=s.device)[:, None].expand_as(pos)
        s[rows[mask], pos[mask].long()] = float(MASK_SENTINEL)
        return s

    def _sums(self, topk, users, valid, data, scores):
        g = self.graph
        sums = batch_metric_sums(
            topk, users, valid, g.test_pos, self.topks, data.item_categories,
            data.item_popularity, n_users_norm=float(g.n_users),
            max_test_degree=g.max_test_degree or None,
        )
        if scores is not None:
            auc = batch_auc_sum(scores, users, valid, g.test_pos, float(MASK_SENTINEL))
            sums["auc"] = auc.expand(len(self.topks))
        return sums

    @torch.no_grad()
    def evaluate(self, data: EvalData):
        """(sums, cold_sums, coverage counts [nk], top-K ids [nb, B, Kmax]) as
        device tensors; cold_sums is None unless config.cold_start."""
        with torch.profiler.record_function("evaluate"):
            user_emb, item_emb = self.embeddings()
            user_emb = user_emb.detach().float().contiguous()
            item_emb = item_emb.detach().float().contiguous()
            g = self.graph
            m = g.m_items
            nk = len(self.topks)
            sums = cold_sums = None
            cov = torch.zeros((nk, m + 1), dtype=torch.bool, device=user_emb.device)
            topks = []
            tiles = zip(data.users, data.valid)
            if self.mesh is not None:
                tiles = self._data_share(data)
                block = item_block(item_emb, self.mesh)
                if self._local_mask is None:
                    self._local_mask = local_mask(g.user_pos, m, self.mesh, m)
            for users, valid in tiles:
                if self.mesh is not None:
                    _, topk = sharded_masked_topk(user_emb, block, users, self.kmax, self._local_mask, self.mesh,
                                                  sigmoid=self.model.score_sigmoid)
                else:
                    _, topk = masked_topk(
                        user_emb, item_emb, users, self.kmax, g.user_pos.indptr, g.user_pos.indices,
                        sigmoid=self.model.score_sigmoid,
                    )
                topks.append(topk)
                scores = (
                    self._scores(user_emb, item_emb, users) if self.config.compute_auc else None
                )
                b = self._sums(topk, users, valid, data, scores)
                sums = b if sums is None else {k: sums[k] + v for k, v in b.items()}
                if self.config.cold_start:
                    cb = self._sums(topk, users, valid & (users < COLD_START_UID), data, scores)
                    cold_sums = cb if cold_sums is None else {
                        k: cold_sums[k] + v for k, v in cb.items()
                    }
                for i, k in enumerate(self.topks):
                    # padding rows write to the extra column m, dropped below
                    ids = torch.where(valid[:, None], topk[:, :k], m)
                    cov[i, ids.reshape(-1)] = True
            topks = torch.stack(topks)
            if self.mesh is not None:
                return self._reduce(sums, cold_sums, cov, topks)
            cov_counts = cov[:, :m].sum(dim=1)
            return sums, cold_sums, cov_counts, topks

    def _data_share(self, data: EvalData):
        """This data rank's rows of each tile (the same number of tiles on
        every rank)."""
        b = data.users.shape[1]
        if b % self.mesh.data:
            raise ValueError(f"evaluation tiles of {b} users do not split over the mesh data axis {self.mesh.data}")
        per = b // self.mesh.data
        lo = self.mesh.index(DATA_AXIS) * per
        return zip(data.users[:, lo : lo + per], data.valid[:, lo : lo + per])

    def _reduce(self, sums, cold_sums, cov, topks):
        """The data ranks' sums, coverage and top-K ids put together (sums
        over ``data``, then rank 0's on every rank)."""
        mesh, m = self.mesh, self.graph.m_items
        parts = [sums] + ([cold_sums] if cold_sums is not None else [])
        keys = [(i, k) for i, part in enumerate(parts) for k in sorted(part)]
        flat = torch.cat([parts[i][k].reshape(-1).float() for i, k in keys]
                         + [cov[:, :m].to(torch.float32).reshape(-1)])
        flat = mesh.broadcast_from_primary(mesh.all_reduce(flat, DATA_AXIS))
        sizes = [parts[i][k].numel() for i, k in keys] + [cov[:, :m].numel()]
        chunks = torch.split(flat, sizes)
        out = [{} for _ in parts]
        for (i, k), c in zip(keys, chunks):
            out[i][k] = c.reshape(parts[i][k].shape)
        cov_counts = (chunks[-1].reshape(cov.shape[0], m) > 0).sum(dim=1)
        nb, per, kmax = topks.shape
        topks = mesh.all_gather(topks, DATA_AXIS).permute(1, 0, 2, 3).reshape(nb, mesh.data * per, kmax)
        return out[0], (out[1] if cold_sums is not None else None), cov_counts, topks

    def __call__(
        self,
        data: EvalData,
        pmi: Optional[np.ndarray] = None,
        with_topk: bool = True,
    ) -> Tuple[Dict[str, float], Optional[np.ndarray]]:
        """(results, top-K ids [n_valid_test_users, Kmax] or None).

        results: {metric}@{k}, coverage@{k}, unexpectedness@{k} (the mean PMI
        when ``pmi`` [M, M] is given, else 1 / #users as the reference stubs
        it), and cold_{metric}@{k} when config.cold_start."""
        sums, cold_sums, cov_counts, topks = self.evaluate(data)
        sums = {k: v.cpu().numpy() for k, v in sums.items()}
        n = float(sums.pop("count"))
        results: Dict[str, float] = {}
        for name, vals in sums.items():
            for i, k in enumerate(self.topks):
                results[f"{name}@{k}"] = float(vals[i]) / max(n, 1.0)
        cov_counts = cov_counts.cpu().numpy()
        for i, k in enumerate(self.topks):
            results[f"coverage@{k}"] = float(cov_counts[i]) / self.model.m_items
        shown = None
        if with_topk or pmi is not None:
            valid_np = data.valid.cpu().numpy().reshape(-1)
            users_np = data.users.cpu().numpy().reshape(-1)[valid_np]
            shown = topks.cpu().numpy().reshape(-1, self.kmax)[valid_np]
        for k in self.topks:
            if pmi is not None:
                results[f"unexpectedness@{k}"] = unexpectedness_from_pmi(
                    self.graph, users_np, shown[:, :k], pmi
                )
            else:
                results[f"unexpectedness@{k}"] = 1.0 / max(n, 1.0)
        if self.config.cold_start:
            cold_sums = {k: v.cpu().numpy() for k, v in cold_sums.items()}
            cn = float(cold_sums.pop("count"))
            for name, vals in cold_sums.items():
                for i, k in enumerate(self.topks):
                    results[f"cold_{name}@{k}"] = float(vals[i]) / max(cn, 1.0)
        return results, shown
