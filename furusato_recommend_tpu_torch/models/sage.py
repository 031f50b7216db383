"""The SAGE / TextSAGE family (port of ``models/sage.py``): one model whose
flags and conv cover the reference's feature-rich GraphSAGE variants.

- Initial (feature) embeddings: per side, the flags ``n`` (numeric, linear),
  ``t`` (three text fields) and ``r`` (the items' review field) as mean word
  embeddings, ``w`` / ``s`` / ``b`` (word2vec, sentence, bert vectors), ``c``
  (mean categorical embedding, with the factorization-machine term under
  ``config.factorization``), concatenated and projected to d; users with id
  < 10000 zeroed under ``config.cold_start``; learned id embeddings
  concatenated in front with ``use_id_embedding`` (node width 2d).
- Serving and evaluation: ``propagate``, exact full-graph neighbour means
  through ``graph.mean_aggregation`` (a CSR SpMM and its transpose), L conv
  layers, then the pinsage head or the towers.
- Training: fanout trees ([B], [B, F], [B, F, F], ...) sampled on the device,
  encoded bottom-up (``encode_seeds``) with dropout ``DROPOUT_RATE`` on the
  neighbour rows; ``--inference sample`` encodes every entity so
  (``propagate_sampled``).

The text bags of every entity are one SpMM of the word table by a bags x
vocabulary matrix with weights 1 / |words|, so the word table's gradient is
the transpose SpMM (``ops/segment.py``). Deviation: the JAX package splits the
4096 most frequent words into a dense bfloat16 block, a TPU layout not carried
over.

Deviation (routing): every row a tree level takes from the all-entity
initial tables goes through ``ops/scatter.py::table_gather``, one call per
side for all the levels of a step's three trees, so the tables' gradient is
one ``scatter_add_rows`` kernel launch per side; so do the categorical
embedding gathers, and rsage's relation rows: one call per layer for every
neighbour slot of the step's trees that the layer consumes, so each
layer's relation table (3 rows) takes its gradient in one kernel launch
that sums repeated ids in shared memory; so do the word rows of the text
bags that ``_initial_side_emb`` assembles per id (sasrec's items, asage's
attribute view), one call a word table: millions of rows a step on a few
hundred words, which PyTorch's indexing backward took 2 s a step to sum on
the H100 (PERF.md). The JAX package takes plain XLA gathers there.

The edge-feature convs (``relational_*``, ``temporal``, ``recency``) read the
features' per-edge arrays at each tree level's ``edge_pos``; rsage's
relation table ``rel_emb`` [max(n_relations, 1), node_dim] is chained
through each layer's ``rel_w`` / ``rel_b`` (layer i reads rel_i, rel_{i+1}
= rel_i @ rel_w + rel_b).

The parameters carry the JAX package's names; layer i's are
``layers.{i}.{name}``. ``loss`` computes the initial tables inside the
differentiated function unless it is given them (``tables=``): one autograd
pass is the JAX trainer's ``relin_every=1`` (and ``train_emb``) gradient, and
the trainer's other cadences pass tables computed at an earlier parameter
snapshot (``tables_at``; ``initial_param_keys`` names the parameters the
tables depend on).

The out-of-core ``dask`` variant (``ooc_numeric={side: MemmapNumeric}``) keeps
a side's numeric matrix on disk: its projection ``X @ W + b`` is streamed once
an epoch (``refresh_ooc_proj``, ``data/ooc.py``) and enters the tables as data.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import Config
from ..convert import flatten_params
from ..core.mesh import DATA_AXIS
from ..data.features import FeatureStore
from ..data.graph import BipartiteGraph
from ..data.ooc import CHUNK, stream_project
from ..ops.scatter import table_gather
from ..ops.segment import SparsePair, spmm
from ..sampling.bpr import BatchShard, draw_rows
from ..sampling.neighbor import SampledNeighbors, sample_neighbors
from .base import PairwiseModel, gather_batch_rows, l2_params, param_norm, row_norm
from .sage_convs import edge_feature, get_conv, xavier

__all__ = ["SAGE", "COLD_START_UID", "DROPOUT_RATE", "dropout"]

COLD_START_UID = 10000
#: dropout on the neighbour rows of every tree level in training; read at
#: call time
DROPOUT_RATE = 0.2


def _other(side: str) -> str:
    return "item" if side == "user" else "user"


def dropout(x: torch.Tensor, generator: Optional[torch.Generator], rate: Optional[float] = None,
            shard: Optional[BatchShard] = None) -> torch.Tensor:
    """Each element kept with probability 1 - rate (default DROPOUT_RATE) and
    scaled by 1 / (1 - rate), else 0; the mask drawn from ``generator`` on
    x's device (the JAX package draws it from its threefry key). ``shard``:
    x's leading axis is that share of a batch's rows, and takes the whole
    batch's mask cut to its rows."""
    rate = DROPOUT_RATE if rate is None else rate
    if rate <= 0:
        return x
    if generator is None:
        raise ValueError("training dropout needs a generator")
    keep = draw_rows(lambda shape: torch.rand(shape, generator=generator, device=x.device), x.shape, shard)
    keep = keep < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class SAGE(PairwiseModel):
    name = "textsage"

    def __init__(
        self,
        config: Config,
        graph: BipartiteGraph,
        features: FeatureStore,
        conv: str = "sage_cat",
        use_id_embedding: bool = False,
        towers: bool = False,
        full_graph_train: bool = False,
        layer_mean_output: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
        ooc_numeric=None,
    ):
        super().__init__(config, graph)
        self.features = features
        #: side -> MemmapNumeric of the out-of-core numeric matrix (dask)
        self.ooc_numeric = dict(ooc_numeric or {})
        for side in self.ooc_numeric:
            if (features.user if side == "user" else features.item).numeric is not None:
                raise ValueError(f"{side}: both in-core numeric features and ooc_numeric given")
        #: side -> the streamed projection X @ W + b [N, d] (refresh_ooc_proj)
        self._ooc_proj: Dict[str, torch.Tensor] = {}
        self.dim = config.latent_dim
        self.n_layers = config.n_layers
        self.fanout = config.num_neighbors
        self.conv_name = conv
        self.conv = get_conv(conv)
        self.use_id = use_id_embedding
        self.towers = towers
        self.full_graph_train = full_graph_train
        # lightsage averages the layer outputs
        self.layer_mean = (conv == "light") if layer_mean_output is None else layer_mean_output
        self.node_dim = self.dim * (2 if use_id_embedding else 1)
        self.word_dim = self.dim // 2
        self.user_flags = config.user_feature
        self.item_flags = config.item_feature

        self._text_adj: Dict[str, SparsePair] = {}
        for side, feats, flags in (
            ("user", features.user, self.user_flags),
            ("item", features.item, self.item_flags),
        ):
            if feats.text is not None and ("t" in flags or ("r" in flags and side == "item")):
                self._text_adj[side] = self._build_text_adj(feats.text, features.text_vocab)

        values = self._init_values(self._generator(generator))
        for name, v in values.items():
            if isinstance(v, list):  # a list of parameter dicts: the conv layers (SASRec's blocks)
                setattr(self, name, nn.ModuleList(
                    nn.ParameterDict({k: nn.Parameter(t) for k, t in lp.items()}) for lp in v))
            else:
                self.register_parameter(name, nn.Parameter(v))

    # ---- set-up ----
    @staticmethod
    def _build_text_adj(text: torch.Tensor, vocab: int) -> SparsePair:
        """[N, T, W] padded word ids -> the (N * T) bags x vocab matrix with
        weight 1 / |words of the bag|, and its transpose."""
        n, fields, w = text.shape
        rows = torch.arange(n * fields, device=text.device).repeat_interleave(w)
        words = text.reshape(-1).long()
        valid = words >= 0
        rows, words = rows[valid], words[valid]
        counts = torch.bincount(rows, minlength=n * fields).double()
        weight = (1.0 / counts[rows].clamp_min(1.0)).float()
        return SparsePair.from_edges(rows, words, weight, n * fields, vocab)

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        return torch.Generator().manual_seed(self.config.seed) if generator is None else generator

    def _proj_in_dim(self, flags: str, side: str) -> int:
        d, f = self.dim, self.features
        feats = f.user if side == "user" else f.item
        total = 0
        for flag in flags:
            if flag == "n":
                total += d
            elif flag == "c":
                total += 2 * d if self.config.factorization else d
            elif flag == "t":
                total += 3 * self.word_dim
            elif flag == "r":
                total += self.word_dim
            elif flag == "w":
                total += feats.word2vec.shape[1]
            elif flag == "s":
                total += f.item.sentence.shape[1]
            elif flag == "b":
                total += feats.bert.shape[1]
        return total

    def _init_values(self, g: torch.Generator) -> dict:
        """Fresh parameter values (CPU): xavier-uniform matrices, zero
        biases, conv layers with gain 0.1 and the last with gain 1."""
        d, nd, f = self.dim, self.node_dim, self.features
        p: dict = {}
        for side, feats, flags in (("user", f.user, self.user_flags), ("item", f.item, self.item_flags)):
            if "n" in flags:
                fn = self.ooc_numeric[side].shape[1] if side in self.ooc_numeric else feats.numeric.shape[1]
                p[f"{side}_numeric_w"] = xavier(g, (fn, d))
                p[f"{side}_numeric_b"] = torch.zeros(d)
        if "c" in self.user_flags:
            p["user_cat_emb"] = xavier(g, (f.user_cat_vocab, d))
        if "c" in self.item_flags:
            p["item_cat_emb"] = xavier(g, (f.item_cat_vocab, d))
        if "t" in self.user_flags or "t" in self.item_flags or "r" in self.item_flags:
            p["word_emb"] = xavier(g, (f.text_vocab, self.word_dim))
        for side, flags in (("user", self.user_flags), ("item", self.item_flags)):
            p[f"{side}_proj_w"] = xavier(g, (self._proj_in_dim(flags, side), d))
            p[f"{side}_proj_b"] = torch.zeros(d)
        if self.use_id:
            p["user_id_emb"] = xavier(g, (self.n_users, d))
            p["item_id_emb"] = xavier(g, (self.m_items, d))
        p["layers"] = [
            self.conv.init(g, nd, 1.0 if i == self.n_layers - 1 else 0.1) for i in range(self.n_layers)
        ]
        if self.conv_name == "pinsage":
            for name in ("g1", "g2"):
                p[f"{name}_w"] = xavier(g, (nd, nd))
                p[f"{name}_b"] = torch.zeros(nd)
        if self.towers:
            for side in ("user", "item"):
                for name in ("tower1", "tower2"):
                    p[f"{side}_{name}_w"] = xavier(g, (nd, nd))
                    p[f"{side}_{name}_b"] = torch.zeros(nd)
        if self.conv_name.startswith("relational"):
            p["rel_emb"] = xavier(g, (max(f.n_relations, 1), nd))
        return p

    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Set every parameter in place to fresh values drawn on the CPU from
        ``generator`` (default: seeded with config.seed)."""
        flat = flatten_params(self._init_values(self._generator(generator)))
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.copy_(flat[name])

    def to(self, *args, **kwargs) -> "SAGE":
        """``nn.Module.to``, and the feature store and text matrices follow
        the parameters' device."""
        super().to(*args, **kwargs)
        dev = next(self.parameters()).device
        self.features = self.features.to(dev)
        self._text_adj = {side: adj.to(dev) for side, adj in self._text_adj.items()}
        self._ooc_proj = {side: x.to(dev) for side, x in self._ooc_proj.items()}
        return self

    # ---- initial (feature) embeddings ----
    def _categorical(self, side: str, cat_ids: torch.Tensor) -> torch.Tensor:
        """Mean categorical embedding over the fields (pad slots included),
        with the factorization-machine second-order term appended under
        config.factorization; the rows come through ``table_gather``."""
        ce = table_gather(getattr(self, f"{side}_cat_emb"), cat_ids)  # [..., Fc, d]
        mean_emb = ce.mean(dim=-2)
        if self.config.factorization:
            sq_sum = ce.sum(dim=-2) ** 2
            sum_sq = (ce**2).sum(dim=-2)
            mean_emb = torch.cat([mean_emb, 0.5 * (sq_sum - sum_sq)], dim=-1)
        return mean_emb

    def _finish(self, side: str, parts: List[torch.Tensor], ids: torch.Tensor, id_rows) -> torch.Tensor:
        x = torch.cat(parts, dim=-1) @ getattr(self, f"{side}_proj_w") + getattr(self, f"{side}_proj_b")
        if side == "user" and self.config.cold_start:
            x = torch.where((ids < COLD_START_UID)[..., None], 0.0, x)
        if self.use_id:
            x = torch.cat([id_rows, x], dim=-1)
        return x

    def _text_bags(self, wids: torch.Tensor) -> torch.Tensor:
        """[..., W] distinct word ids (-1 padded) -> [..., word_dim]: each
        bag's mean learned word embedding. The word rows come through one
        ``table_gather`` (its clamp reads a pad as word 0, masked out here),
        so the word table's gradient, piled on a few hundred words, is one
        scatter-add kernel launch."""
        emb = table_gather(self.word_emb, wids)
        m = (wids >= 0)[..., None].to(emb.dtype)
        return (emb * m).sum(dim=-2) / m.sum(dim=-2).clamp_min(1.0)

    def _initial_side_emb(self, ids: torch.Tensor, side: str) -> torch.Tensor:
        """Initial embeddings of the entities ``ids`` (any shape) of one side,
        assembled per id (the all-entity ``_initial_all`` gives the same rows);
        the text bags' word rows in one ``table_gather``."""
        feats = self.features.user if side == "user" else self.features.item
        flags = self.user_flags if side == "user" else self.item_flags
        ids = ids.long()
        parts: List[torch.Tensor] = []
        if "n" in flags:
            if side in self.ooc_numeric:
                parts.append(self._proj(side, None)[ids])
            else:
                parts.append(feats.numeric[ids] @ getattr(self, f"{side}_numeric_w") + getattr(self, f"{side}_numeric_b"))
        # the three text fields (0-2), then the review field (3): a slice, as
        # a list index would copy it to the card, which a capture refuses
        fields = slice(0 if "t" in flags else 3, 4 if side == "item" and "r" in flags else 3)
        if fields.stop > fields.start:
            bags = self._text_bags(feats.text[ids][..., fields, :])
            parts.extend(bags[..., j, :] for j in range(fields.stop - fields.start))
        if "w" in flags:
            parts.append(feats.word2vec[ids])
        if "c" in flags:
            parts.append(self._categorical(side, feats.categorical[ids]))
        if side == "item" and "s" in flags:
            parts.append(feats.sentence[ids])
        if "b" in flags and feats.bert is not None:
            parts.append(feats.bert[ids])
        id_rows = getattr(self, f"{side}_id_emb")[ids] if self.use_id else None
        return self._finish(side, parts, ids, id_rows)

    def _all_text_bags(self, side: str) -> torch.Tensor:
        """[N, T, word_dim] mean word embeddings of every entity: one SpMM."""
        feats = self.features.user if side == "user" else self.features.item
        n, fields, _ = feats.text.shape
        a, a_t = self._text_adj[side].matrices(self.compute_dtype)
        return spmm(a, self.word_emb, self.compute_dtype, a_t).reshape(n, fields, self.word_dim)

    def _proj(self, side: str, ooc_proj: Optional[Dict[str, torch.Tensor]]) -> torch.Tensor:
        """The out-of-core side's numeric projection: ``ooc_proj``'s, else the
        one ``refresh_ooc_proj`` streamed last."""
        proj = (self._ooc_proj if ooc_proj is None else ooc_proj).get(side)
        if proj is None:
            raise RuntimeError(f"no {side} numeric projection: call refresh_ooc_proj() first")
        return proj

    def _initial_all(self, side: str, ooc_proj: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Initial embeddings of every entity of one side [n, node_dim]. The
        artifacts may cover more entities than the dataset: the first n rows
        count."""
        feats = self.features.user if side == "user" else self.features.item
        flags = self.user_flags if side == "user" else self.item_flags
        n = self.n_users if side == "user" else self.m_items
        n_ent = (
            self.ooc_numeric[side].shape[0]
            if side in self.ooc_numeric and all(
                x is None for x in (feats.categorical, feats.word2vec, feats.sentence, feats.bert, feats.text)
            )
            else feats.n_entities
        )
        if n_ent < n:
            raise ValueError(f"{side} feature artifacts cover {n_ent} entities but the dataset has {n}")
        parts: List[torch.Tensor] = []
        if "n" in flags:
            if side in self.ooc_numeric:
                parts.append(self._proj(side, ooc_proj)[:n])
            else:
                parts.append(
                    feats.numeric[:n] @ getattr(self, f"{side}_numeric_w") + getattr(self, f"{side}_numeric_b")
                )
        if "t" in flags or (side == "item" and "r" in flags):
            bags = self._all_text_bags(side)[:n]
            if "t" in flags:
                parts.extend(bags[:, f] for f in range(3))
            if side == "item" and "r" in flags:
                parts.append(bags[:, 3])
        if "w" in flags:
            parts.append(feats.word2vec[:n])
        if "c" in flags:
            parts.append(self._categorical(side, feats.categorical[:n]))
        if side == "item" and "s" in flags:
            parts.append(feats.sentence[:n])
        if "b" in flags and feats.bert is not None:
            parts.append(feats.bert[:n])
        ids = torch.arange(n, device=parts[0].device)
        id_rows = getattr(self, f"{side}_id_emb") if self.use_id else None
        return self._finish(side, parts, ids, id_rows)

    def initial_tables(self, ooc_proj: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(user_x [N, node_dim], item_x [M, node_dim]): every entity's initial
        embedding. ``ooc_proj``: the out-of-core sides' numeric projections to
        use in place of the streamed ones (the trainer differentiates through
        them)."""
        return self._initial_all("user", ooc_proj), self._initial_all("item", ooc_proj)

    def forward(self, ooc_proj: Optional[Dict[str, torch.Tensor]] = None):
        """The module's call is ``initial_tables``, so that
        ``torch.func.functional_call`` evaluates them at other parameters."""
        return self.initial_tables(ooc_proj)

    def tables_at(
        self, values: Dict[str, torch.Tensor], ooc_proj: Optional[Dict[str, torch.Tensor]] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``initial_tables`` computed with ``values`` (name -> tensor, the
        names of ``initial_param_keys``) in place of those parameters, and
        differentiable with respect to them; the module's parameters are not
        read for those names."""
        return torch.func.functional_call(self, values, (), {"ooc_proj": ooc_proj})

    def initial_param_keys(self) -> FrozenSet[str]:
        """The parameters whose gradient flows only through ``initial_tables``
        (the feature parameters): the projections, the in-core numeric
        linears, the categorical and id embeddings and the word table. The
        trainer's ``feature_update_every`` cadence steps them apart."""
        keys = set()
        for side, flags in (("user", self.user_flags), ("item", self.item_flags)):
            keys.update({f"{side}_proj_w", f"{side}_proj_b"})
            if "n" in flags and side not in self.ooc_numeric:
                keys.update({f"{side}_numeric_w", f"{side}_numeric_b"})
            if "c" in flags:
                keys.add(f"{side}_cat_emb")
            if self.use_id:
                keys.add(f"{side}_id_emb")
        if "t" in self.user_flags or "t" in self.item_flags or "r" in self.item_flags:
            keys.add("word_emb")
        return frozenset(keys)

    @torch.no_grad()
    def refresh_ooc_proj(self, chunk: int = CHUNK) -> Dict[str, torch.Tensor]:
        """Stream each out-of-core side's X @ W + b with the current numeric
        linear onto the parameters' device (``data/ooc.py``). After the first
        call each side's projection is written into the same tensor, which a
        captured linearization reads (``train/graphed.py``)."""
        for side, mm in self.ooc_numeric.items():
            w, b = getattr(self, f"{side}_numeric_w"), getattr(self, f"{side}_numeric_b")
            self._ooc_proj[side] = stream_project(mm, w, b, chunk, out=self._ooc_proj.get(side))
        return self._ooc_proj

    def _head(self, x: torch.Tensor, side: str) -> torch.Tensor:
        if self.conv_name == "pinsage":
            x = torch.relu(x @ self.g1_w + self.g1_b) @ self.g2_w + self.g2_b
        if self.towers:
            h = torch.relu(x @ getattr(self, f"{side}_tower1_w") + getattr(self, f"{side}_tower1_b"))
            x = h @ getattr(self, f"{side}_tower2_w") + getattr(self, f"{side}_tower2_b")
        return x

    def _rel_chain(self) -> Optional[List[torch.Tensor]]:
        """rsage's relation table of each layer: rel_0 = rel_emb, rel_{i+1} =
        rel_i @ rel_w + rel_b of layer i; None for the other convs."""
        if not self.conv_name.startswith("relational"):
            return None
        chain = [self.rel_emb]
        for lp in list(self.layers)[:-1]:
            chain.append(chain[-1] @ lp["rel_w"] + lp["rel_b"])
        return chain

    @staticmethod
    def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)

    # ---- full-graph propagation (serving and evaluation) ----
    def propagate(self, graph: BipartiteGraph, generator: Optional[torch.Generator] = None):
        cdt = self.compute_dtype
        user_x, item_x = self.initial_tables()
        ua, ua_t = graph.mean_aggregation("user").matrices(cdt)
        ia, ia_t = graph.mean_aggregation("item").matrices(cdt)
        rel_chain = self._rel_chain()
        user_layers, item_layers = [user_x], [item_x]
        for i, lp in enumerate(self.layers):
            user_aggr = spmm(ua, item_x, cdt, ua_t)
            item_aggr = spmm(ia, user_x, cdt, ia_t)
            ctx = {"graph": graph, "edge_time": self.features.edge_time, "edge_label": self.features.edge_label,
                   "rel_emb": None if rel_chain is None else rel_chain[i]}
            new_user = self.conv.full_graph(lp, user_x, user_aggr, item_x, "user", ctx)
            new_item = self.conv.full_graph(lp, item_x, item_aggr, user_x, "item", ctx)
            if i != self.n_layers - 1:
                new_user, new_item = torch.relu(new_user), torch.relu(new_item)
            if self.conv_name == "pinsage":
                new_user, new_item = self._l2_normalize(new_user), self._l2_normalize(new_item)
            user_x, item_x = new_user, new_item
            user_layers.append(user_x)
            item_layers.append(item_x)
        if self.layer_mean:
            user_x = sum(user_layers) / len(user_layers)
            item_x = sum(item_layers) / len(item_layers)
        return self._head(user_x, "user"), self._head(item_x, "item")

    # ---- fanout trees (training, --inference sample) ----
    def _sides(self, seed_side: str) -> List[str]:
        sides = [seed_side]
        for _ in range(self.n_layers):
            sides.append(_other(sides[-1]))
        return sides

    def sample_seed_tree(
        self, graph: BipartiteGraph, seeds: torch.Tensor, seed_side: str, generator: torch.Generator,
        shard: Optional[BatchShard] = None,
    ) -> List[SampledNeighbors]:
        """The fanout tree of one seed batch: L levels, level l + 1 sampled
        from level l's nodes over the CSR of their side. ``shard``: the
        seeds are that share of a batch."""
        out: List[SampledNeighbors] = []
        frontier = seeds
        for side in self._sides(seed_side)[:-1]:
            csr = graph.prop_user_pos if side == "user" else graph.prop_item_pos
            s = sample_neighbors(generator, csr, frontier, self.fanout, shard)
            out.append(s)
            frontier = s.ids
        return out

    def _gather_levels(self, tables, trees) -> List[List[torch.Tensor]]:
        """The initial rows of every level of every tree. ``trees``: a list of
        (sides, level ids). One ``table_gather`` per side covers all of them,
        so the backward is one scatter-add kernel per side."""
        ids: Dict[str, List[torch.Tensor]] = {"user": [], "item": []}
        for sides, levels in trees:
            for side, lvl in zip(sides, levels):
                ids[side].append(lvl.reshape(-1))
        rows: Dict[str, Sequence[torch.Tensor]] = {}
        for side, table in zip(("user", "item"), tables):
            if ids[side]:
                flat = table_gather(table, torch.cat(ids[side]))
                rows[side] = torch.split(flat, [t.numel() for t in ids[side]])
        taken = {"user": 0, "item": 0}
        out = []
        for sides, levels in trees:
            xs = []
            for side, lvl in zip(sides, levels):
                xs.append(rows[side][taken[side]].reshape(lvl.shape + (-1,)))
                taken[side] += 1
            out.append(xs)
        return out

    def _gather_relations(self, graph, trees) -> list:
        """rsage's relation rows of every neighbour slot, [tree][layer][level]
        -> [..., F, node_dim], for ``trees``: a list of (sides, edge_pos per
        level). Layer i reads the slots of levels 1 .. L - i; one
        ``table_gather`` of its table covers them in every tree, so its
        backward is one scatter-add kernel launch. A None per tree for the
        other convs."""
        chain = self._rel_chain()
        if chain is None:
            return [None] * len(trees)
        labels = [
            [edge_feature({"edge_pos": pos, "side": side, "graph": graph}, self.features.edge_label)
             for side, pos in zip(sides, edge_pos[1:])]
            for sides, edge_pos in trees
        ]
        out: List[List[List[torch.Tensor]]] = [[] for _ in trees]
        for i, rel in enumerate(chain):
            parts = [lab for tree_labels in labels for lab in tree_labels[: self.n_layers - i]]
            flat = table_gather(rel, torch.cat([lab.reshape(-1) for lab in parts]))
            rows = iter(torch.split(flat, [lab.numel() for lab in parts]))
            for t, tree_labels in enumerate(labels):
                out[t].append([next(rows).reshape(lab.shape + (-1,)) for lab in tree_labels[: self.n_layers - i]])
        return out

    def _combine(self, graph, xs, has_nbr, edge_pos, sides, rel, generator, train: bool,
                 shard: Optional[BatchShard] = None) -> torch.Tensor:
        """Bottom-up SAGE combine of one tree's level rows ``xs``; ``rel``:
        the tree's relation rows (``_gather_relations``), or None; ``shard``:
        the seeds' share of a batch, for the dropout's draws."""
        big_l = self.n_layers
        layer_outputs = [xs[0]]
        for i, lp in enumerate(self.layers):
            new_xs = []
            for lvl in range(big_l - i):
                target, nbrs = xs[lvl], xs[lvl + 1]  # [...], [..., F, node_dim]
                if train:
                    nbrs = dropout(nbrs, generator, shard=shard)
                aggr = torch.where(has_nbr[lvl + 1][..., None], nbrs.mean(dim=-2), 0.0)
                ctx = {"neighbors": nbrs, "side": sides[lvl], "graph": graph, "edge_pos": edge_pos[lvl + 1],
                       "edge_time": self.features.edge_time}
                if rel is not None:
                    ctx["rel"] = rel[i][lvl]
                h = self.conv.sampled(lp, target, aggr, ctx)
                if i != big_l - 1:
                    h = torch.relu(h)
                if self.conv_name == "pinsage":
                    h = self._l2_normalize(h)
                new_xs.append(h)
            xs = new_xs
            layer_outputs.append(xs[0])
        out = xs[0]
        if self.layer_mean:
            out = sum(layer_outputs) / len(layer_outputs)
        return self._head(out, sides[0])

    def encode_seeds(
        self,
        graph: BipartiteGraph,
        seeds: torch.Tensor,
        seed_side: str,
        generator: Optional[torch.Generator] = None,
        train: bool = False,
        tables=None,
        tree: Optional[List[SampledNeighbors]] = None,
    ) -> torch.Tensor:
        """Fanout-tree forward of single-side seed nodes [B] -> [B, node_dim].

        tables: (user_x, item_x) initial embeddings of every entity (computed
        here when None); tree: a presampled ``sample_seed_tree``, else sampled
        here from ``generator``, which also draws the dropout when ``train``."""
        if tables is None:
            tables = self.initial_tables()
        if tree is None:
            tree = self.sample_seed_tree(graph, seeds, seed_side, generator)
        sides = self._sides(seed_side)
        (xs,) = self._gather_levels(tables, [(sides, [seeds] + [s.ids for s in tree])])
        has_nbr = [None] + [s.has_neighbors for s in tree]
        edge_pos = [None] + [s.edge_pos for s in tree]
        (rel,) = self._gather_relations(graph, [(sides, edge_pos)])
        return self._combine(graph, xs, has_nbr, edge_pos, sides, rel, generator, train)

    @torch.no_grad()
    def propagate_sampled(self, graph: BipartiteGraph, generator: torch.Generator, mesh=None):
        """``--inference sample``: every item, then every user, encoded through
        its own sampled tree (no dropout) in chunks of
        config.sample_infer_chunk seeds.

        mesh: a (data, model) mesh whose data ranks split each chunk's
        seeds: every rank draws the whole chunk's tree, as one process does,
        encodes its share of the seeds and the shares are gathered over
        ``data``, so the result is the single-process one on every rank."""
        chunk = self.config.sample_infer_chunk
        if mesh is not None and chunk % mesh.data:
            raise ValueError(f"sample_infer_chunk {chunk} not divisible by mesh data axis {mesh.data}")
        tables = self.initial_tables()
        dev = tables[0].device

        def encode(seeds, side):
            if mesh is None:
                return self.encode_seeds(graph, seeds, side, generator, train=False, tables=tables)
            tree = self.sample_seed_tree(graph, seeds, side, generator)
            per = -(-seeds.shape[0] // mesh.data)
            lo = mesh.index(DATA_AXIS) * per
            mine = slice(lo, min(lo + per, seeds.shape[0]))
            out = torch.zeros((per, self.node_dim), device=dev)
            if mine.stop > mine.start:
                share = [SampledNeighbors(*(x[mine] for x in lvl)) for lvl in tree]
                out[: mine.stop - mine.start] = self.encode_seeds(
                    graph, seeds[mine], side, train=False, tables=tables, tree=share)
            return mesh.all_gather(out, DATA_AXIS).reshape(-1, self.node_dim)[: seeds.shape[0]]

        def encode_all(n, side):
            ids = torch.arange(n, dtype=torch.int32, device=dev)
            return torch.cat([encode(ids[s : s + chunk], side) for s in range(0, n, chunk)])

        item_emb = encode_all(self.m_items, "item")
        user_emb = encode_all(self.n_users, "user")
        return user_emb, item_emb

    # ---- training loss ----
    def _encode_batch(self, graph, batch, generator, trees, tables) -> Tuple[torch.Tensor, ...]:
        """(u, p, n): the batch's seeds encoded through their fanout trees (or,
        for ``full_graph_train``, gathered from the full propagation)."""
        if self.full_graph_train:
            user_emb, item_emb = self.propagate(graph)
            return gather_batch_rows(user_emb, item_emb, batch)
        seeds = ((batch.user, "user"), (batch.pos, "item"), (batch.neg, "item"))
        if trees is None:
            trees = [self.sample_seed_tree(graph, s, side, generator, batch.shard) for s, side in seeds]
        specs = [
            (self._sides(side), [s] + [lvl.ids for lvl in tree], [None] + [lvl.has_neighbors for lvl in tree],
             [None] + [lvl.edge_pos for lvl in tree])
            for (s, side), tree in zip(seeds, trees)
        ]
        if tables is None:
            tables = self.initial_tables()
        xs_all = self._gather_levels(tables, [(sides, lv) for sides, lv, _, _ in specs])
        rel_all = self._gather_relations(graph, [(sides, pos) for sides, _, _, pos in specs])
        return tuple(
            self._combine(graph, xs, has_nbr, pos, sides, rel, generator, train=True, shard=batch.shard)
            for xs, rel, (sides, _, has_nbr, pos) in zip(xs_all, rel_all, specs)
        )

    def loss(
        self,
        graph: BipartiteGraph,
        batch,
        generator: Optional[torch.Generator] = None,
        trees: Optional[Sequence[List[SampledNeighbors]]] = None,
        tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        """BPR on the encoded (user, pos, neg) seeds plus decay x the
        whole-parameter L2 over the number of valid rows. trees: presampled
        (user, pos, neg) fanout trees, else sampled from ``generator``, which
        also draws the dropout. tables: the (user_x, item_x) initial tables,
        else computed here from the parameters. ``full_graph_train`` (nssage)
        runs the full propagation and gathers the batch rows from it
        instead."""
        u, p, n = self._encode_batch(graph, batch, generator, trees, tables)
        bpr = self.main_loss(u, p, n, batch.valid, row_norm(batch), batch.shard)
        reg = l2_params(self.parameters()) / param_norm(batch)
        return bpr + self.config.decay * reg, {"bpr": bpr, "reg": reg}
