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
(``propagate_sampled``, drawn from the Evaluator's generator, seeded with
config.seed before each evaluation) for the models that have it, the SAGE
family; the others propagate as usual.

No step of an evaluation waits for the card (the train positives masked in
the AUC matrix through an extra column that is dropped, as the JAX package
drops them; the coverage bitmap written by ``index_fill_``), so on one CUDA
device the whole evaluation is captured once as a CUDA graph and replayed
(``eval/graphed.py``), the counterpart of the JAX package's one program. Its
results reach the host in one copy, in ``__call__``.

Under a (data, model) mesh every rank propagates (``--inference sample``
splits its seeds over ``data``), then each tile's users are split over
``data`` and scored against the rank's block of the catalog
(``eval/sharded.py::local_topk``, one ``masked_topk`` launch a tile on every
rank: ``local_candidates``); every tile's candidates are exchanged over
``model`` in one collective, then each tile is merged (``merge_topk``) and
summed (``merged``). The metric sums and the coverage are summed over the
data group only (the model ranks hold the same numbers), then every rank
takes rank 0's, so that every rank decides alike on them; the top-K ids are
gathered over ``data`` (``_reduce``). On a CUDA device the two parts are
replayed as graphs and the collectives run eagerly around them
(``eval/graphed.py``), except under ``--inference sample``, whose gathers
sit inside the propagation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..core.mesh import DATA_AXIS, MODEL_AXIS
from ..data.dataset import Dataset
from ..data.graph import BipartiteGraph
from ..models.base import PairwiseModel
from ..ops.csr_search import csr_gather_padded
from ..ops.streaming_topk import masked_topk
from .graphed import EvalGraph, captured
from .metrics import batch_auc_sum, batch_metric_sums, unexpectedness_from_pmi
from .sharded import item_block, local_mask, local_topk, merge_topk

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
        #: --inference sample's generator, made at its first evaluation
        self.generator: Optional[torch.Generator] = None
        #: the captured evaluation (``eval/graphed.py``), made at the first
        #: evaluation where ``captured`` holds
        self.graphed: Optional[EvalGraph] = None

    @property
    def device(self) -> torch.device:
        return self.graph.user_pos.indptr.device

    @property
    def sampled(self) -> bool:
        """Whether the embeddings come from ``propagate_sampled``."""
        return self.config.inference == "sample" and hasattr(self.model, "propagate_sampled")

    def seed(self) -> None:
        """Seed the generator of --inference sample with config.seed (made
        at the first call), before each evaluation; nothing otherwise."""
        if self.sampled:
            if self.generator is None:
                self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(self.config.seed)

    @torch.no_grad()
    def embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (user, item) embeddings the evaluation scores with."""
        self.seed()
        return self._embeddings()

    def _embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The embeddings, --inference sample's drawn from the generator
        where it stands."""
        if self.sampled:
            if self.mesh is not None:
                return self.model.propagate_sampled(self.graph, self.generator, mesh=self.mesh)
            return self.model.propagate_sampled(self.graph, self.generator)
        return self.model.propagate(self.graph)

    def drop(self) -> None:
        """Drop the captured evaluation and release its memory pool (the
        next evaluation warms up, the one after captures anew)."""
        if self.graphed is not None:
            self.graphed.drop()

    def _scores(self, user_emb, item_emb, users) -> torch.Tensor:
        """The full [B, M] masked score matrix (for AUC): every train
        positive set to the sentinel through an extra column m, which padded
        slots take and which is dropped (the JAX package's scatter with
        mode="drop")."""
        m = item_emb.shape[0]
        s = (user_emb[users.long()] @ item_emb.T).float()
        if self.model.score_sigmoid:
            s = torch.sigmoid(s)
        pos, mask = csr_gather_padded(self.graph.user_pos, users, self.max_train_degree)
        cols = torch.where(mask, pos.long(), m)
        s = torch.nn.functional.pad(s, (0, 1))
        s.scatter_(1, cols, float(MASK_SENTINEL))
        return s[:, :m]

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
        device tensors; cold_sums is None unless config.cold_start. Where
        ``captured`` holds (a CUDA device; under a mesh, unless --inference
        sample) the first call runs eagerly and every later one replays the
        captured evaluation (``eval/graphed.py``); the tensors are then the
        graph's outputs, which the next evaluation overwrites (a mesh's
        reduced sums and ids are made anew)."""
        if captured(self.mesh, self.device, self.config, self.model, evaluation=True):
            if self.graphed is None:
                self.graphed = EvalGraph(self)
            return self.graphed.run(data)
        self.seed()
        return self.program(data)

    def program(self, data: EvalData):
        """One evaluation as ``evaluate`` returns it, with --inference
        sample's generator where it stands: what the captured graph
        records. Under a mesh: ``local_candidates``, the exchange of every
        tile's candidates over ``model``, ``merged`` and ``_reduce`` in a
        row (the captured evaluation replays the first and the third as
        graphs and runs the collectives eagerly between them)."""
        if self.mesh is not None:
            cands = self.mesh.all_reduce(self.local_candidates(data), MODEL_AXIS)
            return self._reduce(*self.merged(data, cands))
        with torch.profiler.record_function("evaluate"):
            user_emb, item_emb = self._float_embeddings()
            g = self.graph
            acc = self._new_sums(user_emb.device)
            topks = []
            for users, valid in zip(data.users, data.valid):
                _, topk = masked_topk(
                    user_emb, item_emb, users, self.kmax, g.user_pos.indptr, g.user_pos.indices,
                    sigmoid=self.model.score_sigmoid,
                )
                topks.append(topk)
                scores = (
                    self._scores(user_emb, item_emb, users) if self.config.compute_auc else None
                )
                self._add_tile(acc, topk, users, valid, data, scores)
            return acc["sums"], acc["cold"], acc["cov"][:, : g.m_items].sum(dim=1), torch.stack(topks)

    def _float_embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        user_emb, item_emb = self._embeddings()
        return user_emb.detach().float().contiguous(), item_emb.detach().float().contiguous()

    def _new_sums(self, device) -> dict:
        """The evaluation's accumulators: the metric sums and cold-start sums
        (made at the first tile) and the coverage bitmap [nk, M + 1]."""
        cov = torch.zeros((len(self.topks), self.graph.m_items + 1), dtype=torch.bool, device=device)
        return {"sums": None, "cold": None, "cov": cov}

    def _add_tile(self, acc: dict, topk, users, valid, data: EvalData, scores) -> None:
        """One tile's metric sums, cold-start sums and coverage added to
        ``acc``."""
        b = self._sums(topk, users, valid, data, scores)
        acc["sums"] = b if acc["sums"] is None else {k: acc["sums"][k] + v for k, v in b.items()}
        if self.config.cold_start:
            cb = self._sums(topk, users, valid & (users < COLD_START_UID), data, scores)
            acc["cold"] = cb if acc["cold"] is None else {k: acc["cold"][k] + v for k, v in cb.items()}
        m = self.graph.m_items
        for i, k in enumerate(self.topks):
            # padding rows write to the extra column m, dropped by the count
            ids = torch.where(valid[:, None], topk[:, :k], m)
            acc["cov"][i].index_fill_(0, ids.reshape(-1), True)

    def local_candidates(self, data: EvalData) -> torch.Tensor:
        """A mesh's first part: the propagation, this model rank's block of
        the catalog and every tile's local top k over it (``local_topk``, one
        kernel launch a tile) for this data rank's users. Returns the
        candidates as [S, 2, nb, B / data, kl] float64 (values, global ids;
        both exact in float64), this model rank's slot filled and the others
        zero: their sum over ``model`` is every rank's (the exchange)."""
        with torch.profiler.record_function("evaluate"):
            user_emb, item_emb = self._float_embeddings()
            mesh, g = self.mesh, self.graph
            block = item_block(item_emb, mesh)
            if self._local_mask is None:
                self._local_mask = local_mask(g.user_pos, g.m_items, mesh, g.m_items)
            vals, ids = zip(*(local_topk(user_emb, block, users, self.kmax, self._local_mask, mesh,
                                         sigmoid=self.model.score_sigmoid)
                              for users, _ in self._data_share(data)))
            vals, ids = torch.stack(vals), torch.stack(ids)
            cands = vals.new_zeros((mesh.model, 2) + tuple(vals.shape), dtype=torch.float64)
            cands[mesh.index(MODEL_AXIS), 0] = vals
            cands[mesh.index(MODEL_AXIS), 1] = ids
            return cands

    def merged(self, data: EvalData, cands: torch.Tensor):
        """A mesh's second part, on the exchanged candidates: every tile's
        merge (``merge_topk``), metric sums, cold-start sums and coverage:
        (sums, cold_sums, coverage bitmap [nk, M + 1], top-K ids [nb, B /
        data, Kmax]) of this data rank, for ``_reduce``."""
        with torch.profiler.record_function("evaluate"):
            acc = self._new_sums(cands.device)
            topks = []
            for t, (users, valid) in enumerate(self._data_share(data)):
                _, topk = merge_topk(cands[:, 0, t].float(), cands[:, 1, t].long(), self.kmax)
                topks.append(topk)
                self._add_tile(acc, topk, users, valid, data, None)
            return acc["sums"], acc["cold"], acc["cov"], torch.stack(topks)

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
        parts = [sums] + ([cold_sums] if self.config.cold_start else [])
        pieces = [v.reshape(-1) for part in parts for v in part.values()] + [cov_counts]
        with_ids = with_topk or pmi is not None
        if with_ids:
            pieces += [data.users.reshape(-1), data.valid.reshape(-1), topks.reshape(-1)]
        # the evaluation's one copy to the host: float64 holds every sum and id exactly
        flat = torch.cat([p.double() for p in pieces]).cpu().numpy()
        chunks = iter(np.split(flat, np.cumsum([p.numel() for p in pieces])[:-1]))
        sums, *cold = [{k: next(chunks) for k in part} for part in parts]
        n = float(sums.pop("count")[0])
        results: Dict[str, float] = {}
        for name, vals in sums.items():
            for i, k in enumerate(self.topks):
                results[f"{name}@{k}"] = float(vals[i]) / max(n, 1.0)
        cov_counts = next(chunks)
        for i, k in enumerate(self.topks):
            results[f"coverage@{k}"] = float(cov_counts[i]) / self.model.m_items
        shown = None
        if with_ids:
            users_np, valid_np, ids = (next(chunks) for _ in range(3))
            valid_np = valid_np.astype(bool)
            users_np = users_np[valid_np].astype(np.int64)
            shown = ids.astype(np.int64).reshape(-1, self.kmax)[valid_np]
        for k in self.topks:
            if pmi is not None:
                results[f"unexpectedness@{k}"] = unexpectedness_from_pmi(
                    self.graph, users_np, shown[:, :k], pmi
                )
            else:
                results[f"unexpectedness@{k}"] = 1.0 / max(n, 1.0)
        if self.config.cold_start:
            cold_sums = cold[0]
            cn = float(cold_sums.pop("count")[0])
            for name, vals in cold_sums.items():
                for i, k in enumerate(self.topks):
                    results[f"cold_{name}@{k}"] = float(vals[i]) / max(cn, 1.0)
        return results, shown
