"""Conv plugins of the SAGE family (port of ``models/sage_convs.py``).

Each conv is a triple of functions over one layer's parameters ``lp`` (a
mapping name -> tensor, the JAX package's names):

- ``init(generator, dim, gain) -> {name: tensor}``, xavier-uniform matrices
  drawn from a ``torch.Generator``, zero biases;
- ``sampled(lp, target, aggr, ctx)``: the training path over fanout-sampled
  neighbours; ``ctx["neighbors"]`` holds the raw [..., F, d] block;
- ``full_graph(lp, x_self, aggr, other_x, side, ctx)``: the exact full-graph
  path; ``ctx["graph"]`` is the graph.

Ported: ``sage_cat`` (TextSAGE's W[cat(self, aggr)]), ``sage_w2`` (separate
self / neighbour weights), ``light`` (parameterless target + aggr),
``pinsage`` (a source transform before the mean), ``gcn``, ``ggnn``, and the
attention convs: ``gat`` (single-head additive attention), ``transformer``
(TGRec's TransformerConv: ``N_HEADS`` heads of dot-product attention, a root
weight) and ``transformer_cat`` (TGRec2's W[cat(attention, x)]). Their
full-graph paths are segment softmaxes over the side's CSR
(``ops/segment.py``); their sampled paths attend over all F slots of the
(dropped-out) neighbour block, the clipped slot of a node without neighbours
included, as the JAX package does.

The edge-feature convs read per-edge arrays held in the message user-CSR edge
order (``FeatureStore.edge_time`` / ``edge_label``); the item side reaches
them through ``graph.prop_item_edge_perm``. ``relational_{add,sum,prod}``
(rsage) mix a relation embedding into each source message; ``temporal``
(tgsrec) puts a time encoding into the keys and values of ``N_HEADS``-head
attention; ``recency`` (sasgnn) gates the users' mean with their most recent
neighbour. A sampled slot's edge is ``ctx["edge_pos"]``, which for a node
without neighbours is the clipped position of another node's edge: its label
and time are read unmasked, as the JAX package reads them. The sampled
relational path takes the relation rows of its slots as ``ctx["rel"]``: the
model gathers them for a whole step through ``table_gather``
(``models/sage.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.csr_search import csr_row_ids
from ..ops.segment import (
    segment_max,
    segment_mean,
    segment_mh_attention,
    segment_softmax,
    segment_softmax_aggregate,
    segment_sum,
)

__all__ = ["Conv", "N_HEADS", "edge_feature", "get_conv", "xavier"]

N_HEADS = 8  # TransformerConv heads (tgrec, tgrec2, tgsrec)


def xavier(generator: Optional[torch.Generator], shape, gain: float = 1.0) -> torch.Tensor:
    """U(-a, a), a = gain * sqrt(6 / (fan_in + fan_out)), on the CPU."""
    a = gain * (6.0 / (shape[0] + shape[-1])) ** 0.5
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * a


@dataclass(frozen=True)
class Conv:
    init: Callable  # (generator, dim, gain) -> {name: tensor}
    sampled: Callable  # (lp, target, aggr, ctx) -> new target
    full_graph: Callable  # (lp, x_self, aggr, other_x, side, ctx) -> new x


# ---- textsage: W [cat(self, aggr)] ----
def _cat_init(g, dim, gain):
    return {"w": xavier(g, (2 * dim, dim), gain), "b": torch.zeros(dim)}


def _cat_sampled(lp, target, aggr, ctx):
    return torch.cat([target, aggr], dim=-1) @ lp["w"] + lp["b"]


def _cat_full(lp, x_self, aggr, other_x, side, ctx):
    return torch.cat([x_self, aggr], dim=-1) @ lp["w"] + lp["b"]


# ---- fastsage: separate self / neighbour weights (SAGEConv) ----
def _w2_init(g, dim, gain):
    return {
        "w_self": xavier(g, (dim, dim), gain),
        "w_nbr": xavier(g, (dim, dim), gain),
        "b": torch.zeros(dim),
    }


def _w2_sampled(lp, target, aggr, ctx):
    return target @ lp["w_self"] + aggr @ lp["w_nbr"] + lp["b"]


def _w2_full(lp, x_self, aggr, other_x, side, ctx):
    return x_self @ lp["w_self"] + aggr @ lp["w_nbr"] + lp["b"]


# ---- lightsage: parameterless target + aggr ----
def _light_init(g, dim, gain):
    return {}


def _light_sampled(lp, target, aggr, ctx):
    return target + aggr


def _light_full(lp, x_self, aggr, other_x, side, ctx):
    return x_self + aggr


# ---- pinsage: transform the sources before the mean ----
def _pin_init(g, dim, gain):
    return {
        "q_w": xavier(g, (dim, dim), gain),
        "q_b": torch.zeros(dim),
        "w": xavier(g, (2 * dim, dim), gain),
        "b": torch.zeros(dim),
    }


def _pin_sampled(lp, target, aggr, ctx):
    # the mean of relu(q(source)) over the raw neighbours, not of the sources
    q = torch.relu(ctx["neighbors"] @ lp["q_w"] + lp["q_b"])
    return torch.cat([target, q.mean(dim=-2)], dim=-1) @ lp["w"] + lp["b"]


def _pin_full(lp, x_self, aggr, other_x, side, ctx):
    # relu(q(.)) does not pass through the precomputed mean: a segment mean
    # over the edges of the side's CSR
    graph = ctx["graph"]
    q_other = torch.relu(other_x @ lp["q_w"] + lp["q_b"])
    csr = graph.prop_user_pos if side == "user" else graph.prop_item_pos
    aggr_q = segment_mean(q_other[csr.indices.long()], csr_row_ids(csr), csr.num_rows)
    return torch.cat([x_self, aggr_q], dim=-1) @ lp["w"] + lp["b"]


# ---- gcn: the mean over neighbours and self, then linear ----
def _gcn_init(g, dim, gain):
    return {"w": xavier(g, (dim, dim), gain), "b": torch.zeros(dim)}


def _gcn_sampled(lp, target, aggr, ctx):
    f = ctx["neighbors"].shape[-2]
    return ((aggr * f + target) / (f + 1)) @ lp["w"] + lp["b"]


def _gcn_full(lp, x_self, aggr, other_x, side, ctx):
    return (0.5 * (aggr + x_self)) @ lp["w"] + lp["b"]


# ---- gat: single-head additive attention over the neighbours ----
def _gat_init(g, dim, gain):
    return {
        "w": xavier(g, (dim, dim), gain),
        "a_src": xavier(g, (dim, 1), gain),
        "a_dst": xavier(g, (dim, 1), gain),
        "b": torch.zeros(dim),
    }


def _gat_sampled(lp, target, aggr, ctx):
    nbrs = ctx["neighbors"] @ lp["w"]  # [..., F, d]
    tgt = target @ lp["w"]  # [..., d]
    e = torch.nn.functional.leaky_relu(
        (nbrs @ lp["a_src"])[..., 0] + (tgt @ lp["a_dst"])[..., 0][..., None], 0.2
    )  # [..., F]
    alpha = torch.softmax(e, dim=-1)
    return (alpha[..., None] * nbrs).sum(dim=-2) + tgt + lp["b"]


def _gat_full(lp, x_self, aggr, other_x, side, ctx):
    graph = ctx["graph"]
    csr = graph.prop_user_pos if side == "user" else graph.prop_item_pos
    nbr_proj = other_x @ lp["w"]
    self_proj = x_self @ lp["w"]
    out = segment_softmax_aggregate(
        csr, (nbr_proj @ lp["a_src"])[..., 0], (self_proj @ lp["a_dst"])[..., 0], nbr_proj,
        x_self.shape[0],
    )
    return out + self_proj + lp["b"]


# ---- transformer (tgrec, tgrec2): multi-head dot-product attention ----
def _mh_attention(lp, target, nbrs):
    """Per head, a softmax over the F neighbours of <q, k> / sqrt(dh), then
    the weighted sum of their values; heads concatenated. The two
    contractions are broadcast products and sums. As einsums they become
    batched matrix products of one row by dh columns, one per node and head:
    on an NVIDIA H100 80GB HBM3 at 700 W, a tgrec training step at
    ``chip_smoke.py`` phase 13's shape took 10.19 ms of device work that
    way and 3.97 ms this way (``tools/attention_forms.py``). ``nbrs`` [...,
    F, *]: the keys' and values' inputs (tgsrec's carry a time encoding)."""
    d = target.shape[-1]
    dh = d // N_HEADS
    q = (target @ lp["wq"]).reshape(target.shape[:-1] + (N_HEADS, dh))
    k = (nbrs @ lp["wk"]).reshape(nbrs.shape[:-1] + (N_HEADS, dh))
    v = (nbrs @ lp["wv"]).reshape(nbrs.shape[:-1] + (N_HEADS, dh))
    e = (q[..., None, :, :] * k).sum(dim=-1) / dh**0.5  # [..., F, H]
    alpha = torch.softmax(e, dim=-2)
    return (alpha[..., None] * v).sum(dim=-3).reshape(target.shape)


def _tf_conv(cat_combine: bool) -> Conv:
    """``transformer`` (tgrec: attention plus a root weight, x @ w_skip) or,
    with ``cat_combine``, ``transformer_cat`` (tgrec2: W[cat(attention, x)])."""

    def init(g, dim, gain):
        p = {name: xavier(g, (dim, dim), gain) for name in ("wq", "wk", "wv")}
        if cat_combine:
            p["w_out"] = xavier(g, (2 * dim, dim), gain)
            p["b_out"] = torch.zeros(dim)
        else:
            p["w_skip"] = xavier(g, (dim, dim), gain)
        return p

    def combine(lp, out, x):
        if cat_combine:
            return torch.cat([out, x], dim=-1) @ lp["w_out"] + lp["b_out"]
        return out + x @ lp["w_skip"]

    def sampled(lp, target, aggr, ctx):
        return combine(lp, _mh_attention(lp, target, ctx["neighbors"]), target)

    def full(lp, x_self, aggr, other_x, side, ctx):
        graph = ctx["graph"]
        csr = graph.prop_user_pos if side == "user" else graph.prop_item_pos
        return combine(lp, segment_mh_attention(lp, x_self, other_x, csr, N_HEADS), x_self)

    return Conv(init, sampled, full)


# ---- ggnn: GRU-gated update ----
def _ggnn_init(g, dim, gain):
    return {name: xavier(g, (dim, dim), gain) for name in ("wz", "uz", "wr", "ur", "wh", "uh")}


def _ggnn_update(lp, x, m):
    z = torch.sigmoid(m @ lp["wz"] + x @ lp["uz"])
    r = torch.sigmoid(m @ lp["wr"] + x @ lp["ur"])
    h = torch.tanh(m @ lp["wh"] + (r * x) @ lp["uh"])
    return (1 - z) * x + z * h


def _ggnn_sampled(lp, target, aggr, ctx):
    return _ggnn_update(lp, target, aggr)


def _ggnn_full(lp, x_self, aggr, other_x, side, ctx):
    return _ggnn_update(lp, x_self, aggr)


_CONVS: Dict[str, Conv] = {
    "sage_cat": Conv(_cat_init, _cat_sampled, _cat_full),
    "sage_w2": Conv(_w2_init, _w2_sampled, _w2_full),
    "light": Conv(_light_init, _light_sampled, _light_full),
    "pinsage": Conv(_pin_init, _pin_sampled, _pin_full),
    "gcn": Conv(_gcn_init, _gcn_sampled, _gcn_full),
    "gat": Conv(_gat_init, _gat_sampled, _gat_full),
    "transformer": _tf_conv(cat_combine=False),
    "transformer_cat": _tf_conv(cat_combine=True),
    "ggnn": Conv(_ggnn_init, _ggnn_sampled, _ggnn_full),
}


# ---- edge-feature convs: per-edge arrays in the message user-CSR edge order ----
def edge_feature(ctx, feat_user_order: torch.Tensor) -> torch.Tensor:
    """The per-edge array's value at each sampled slot (``ctx["edge_pos"]``,
    positions in the side's message CSR)."""
    pos = ctx["edge_pos"].long()
    if ctx["side"] == "item":
        pos = ctx["graph"].prop_item_edge_perm[pos].long()
    return feat_user_order[pos]


def _edge_feat_full(graph, side, feat_user_order: torch.Tensor) -> torch.Tensor:
    """The per-edge array in the side's message CSR order."""
    if side == "user":
        return feat_user_order
    return feat_user_order[graph.prop_item_edge_perm.long()]


# ---- relational (rsage): relation embeddings mixed into the source messages.
# 'sum' concatenates source and relation (the reference's naming), 'prod'
# multiplies, 'add' adds; the model chains the per-layer relation transform
# (rel_w, rel_b) and passes layer i's table as ctx["rel_emb"].
def _rel_combine(mode: str, src: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    if mode == "sum":
        return torch.cat([src, rel], dim=-1)
    if mode == "prod":
        return src * rel
    return src + rel


def _relational_conv(mode: str) -> Conv:
    def init(g, dim, gain):
        src_dim = 2 * dim if mode == "sum" else dim
        return {
            "w": xavier(g, (dim + src_dim, dim), gain),
            "b": torch.zeros(dim),
            "rel_w": xavier(g, (dim, dim), gain),
            "rel_b": torch.zeros(dim),
        }

    def sampled(lp, target, aggr, ctx):
        # ctx["rel"] [..., F, d]: the relation rows of the neighbour slots
        m_aggr = _rel_combine(mode, ctx["neighbors"], ctx["rel"]).mean(dim=-2)
        return torch.cat([target, m_aggr], dim=-1) @ lp["w"] + lp["b"]

    def full(lp, x_self, aggr, other_x, side, ctx):
        # aggr is not read: the mean runs over the combined messages
        graph = ctx["graph"]
        csr = graph.prop_user_pos if side == "user" else graph.prop_item_pos
        labels = _edge_feat_full(graph, side, ctx["edge_label"]).long()
        msg = _rel_combine(mode, other_x[csr.indices.long()], ctx["rel_emb"][labels])
        m_aggr = segment_mean(msg, csr_row_ids(csr), x_self.shape[0])
        return torch.cat([x_self, m_aggr], dim=-1) @ lp["w"] + lp["b"]

    return Conv(init, sampled, full)


# ---- temporal (tgsrec): the Bochner time encoding cos(t * omega + phi)
# concatenated into the keys' and values' inputs of a TransformerConv with a
# root weight; omega and phi are trained
def _time_encode(lp, t: torch.Tensor) -> torch.Tensor:
    return torch.cos(t[..., None] * lp["time_freq"] + lp["time_phase"])


def _temporal_init(g, dim, gain):
    return {
        "time_freq": torch.from_numpy((1.0 / 10 ** np.linspace(0, 9, dim)).astype(np.float32)),
        "time_phase": torch.zeros(dim),
        "wq": xavier(g, (dim, dim), gain),
        "wk": xavier(g, (2 * dim, dim), gain),
        "wv": xavier(g, (2 * dim, dim), gain),
        "w_skip": xavier(g, (dim, dim), gain),
    }


def _temporal_sampled(lp, target, aggr, ctx):
    te = _time_encode(lp, edge_feature(ctx, ctx["edge_time"]))  # [..., F, d]
    kv_in = torch.cat([ctx["neighbors"], te], dim=-1)
    return _mh_attention(lp, target, kv_in) + target @ lp["w_skip"]


def _temporal_full(lp, x_self, aggr, other_x, side, ctx):
    graph = ctx["graph"]
    csr = graph.prop_user_pos if side == "user" else graph.prop_item_pos
    te = _time_encode(lp, _edge_feat_full(graph, side, ctx["edge_time"]))  # [E, d]
    num_dst, d = x_self.shape
    dh = d // N_HEADS
    rows = csr_row_ids(csr).long()
    kv_in = torch.cat([other_x[csr.indices.long()], te], dim=-1)
    q = (x_self @ lp["wq"]).reshape(num_dst, N_HEADS, dh)
    k = (kv_in @ lp["wk"]).reshape(-1, N_HEADS, dh)
    v = (kv_in @ lp["wv"]).reshape(-1, N_HEADS, dh)
    alpha = segment_softmax((q[rows] * k).sum(dim=-1) / dh**0.5, rows, num_dst)  # [E, H]
    out = segment_sum(v * alpha[..., None], rows, num_dst).reshape(num_dst, d)
    return out + x_self @ lp["w_skip"]


# ---- recency (sasgnn): each user's most recent neighbour gates its mean,
# aggr + aggr * recent; the item side keeps the plain mean
def _recency_init(g, dim, gain):
    return {"w": xavier(g, (2 * dim, dim), gain), "b": torch.zeros(dim)}


def _recency_sampled(lp, target, aggr, ctx):
    out = aggr
    if ctx["side"] == "user":
        nbrs = ctx["neighbors"]
        # the first slot of the latest time (torch.argmax returns the first
        # maximum, as jnp.argmax does): two slots that drew the same edge tie
        # while dropout leaves their rows different. Its row is taken by a
        # one-hot sum over the slots, exact (the other slots add zeros), whose
        # gradient is a product where a gather's would be torch's scatter-add
        idx = torch.argmax(edge_feature(ctx, ctx["edge_time"]), dim=-1)
        first = (torch.arange(nbrs.shape[-2], device=idx.device) == idx[..., None]).to(nbrs.dtype)
        recent = (first[..., None] * nbrs).sum(dim=-2)
        out = aggr + aggr * recent
    return torch.cat([target, out], dim=-1) @ lp["w"] + lp["b"]


def _recency_full(lp, x_self, aggr, other_x, side, ctx):
    out = aggr
    if side == "user":
        # the mean of every neighbour tied at the latest time; an empty row's
        # -inf maximum is set to 0
        graph = ctx["graph"]
        csr = graph.prop_user_pos
        num_dst = x_self.shape[0]
        rows = csr_row_ids(csr).long()
        t = ctx["edge_time"]
        tmax = segment_max(t, rows, num_dst)
        tmax = torch.where(torch.isfinite(tmax), tmax, 0.0)
        sel = (t >= tmax[rows]).to(x_self.dtype)
        cnt = segment_sum(sel, rows, num_dst)
        recent = segment_sum(other_x[csr.indices.long()] * sel[:, None], rows, num_dst)
        out = aggr + aggr * (recent / cnt.clamp_min(1.0)[:, None])
    return torch.cat([x_self, out], dim=-1) @ lp["w"] + lp["b"]


for _mode in ("add", "sum", "prod"):
    _CONVS[f"relational_{_mode}"] = _relational_conv(_mode)
_CONVS["temporal"] = Conv(_temporal_init, _temporal_sampled, _temporal_full)
_CONVS["recency"] = Conv(_recency_init, _recency_sampled, _recency_full)


def get_conv(name: str) -> Conv:
    # the reference's --conv {sage, mean} map onto the textsage combine
    aliases = {"sage": "sage_cat", "mean": "sage_cat"}
    name = aliases.get(name, name)
    if name not in _CONVS:
        raise KeyError(f"unknown conv {name!r}; available: {sorted(_CONVS)}")
    return _CONVS[name]
