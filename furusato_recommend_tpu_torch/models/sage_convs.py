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
``pinsage`` (a source transform before the mean), ``gcn`` and ``ggnn``. The
attention and edge-feature convs (``gat``, ``transformer``,
``transformer_cat``, ``relational_*``, ``temporal``, ``recency``) belong to the
next SAGE slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..ops.segment import segment_mean

__all__ = ["Conv", "get_conv", "xavier"]

#: convs of the JAX package that the next SAGE slice ports
NOT_PORTED = (
    "gat", "transformer", "transformer_cat", "relational_add", "relational_sum",
    "relational_prod", "temporal", "recency",
)


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
    rows = torch.repeat_interleave(
        torch.arange(csr.num_rows, device=csr.indptr.device), csr.degrees().long()
    )
    aggr_q = segment_mean(q_other[csr.indices.long()], rows, csr.num_rows)
    return torch.cat([x_self, aggr_q], dim=-1) @ lp["w"] + lp["b"]


# ---- gcn: the mean over neighbours and self, then linear ----
def _gcn_init(g, dim, gain):
    return {"w": xavier(g, (dim, dim), gain), "b": torch.zeros(dim)}


def _gcn_sampled(lp, target, aggr, ctx):
    f = ctx["neighbors"].shape[-2]
    return ((aggr * f + target) / (f + 1)) @ lp["w"] + lp["b"]


def _gcn_full(lp, x_self, aggr, other_x, side, ctx):
    return (0.5 * (aggr + x_self)) @ lp["w"] + lp["b"]


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
    "ggnn": Conv(_ggnn_init, _ggnn_sampled, _ggnn_full),
}


def get_conv(name: str) -> Conv:
    # the reference's --conv {sage, mean} map onto the textsage combine
    aliases = {"sage": "sage_cat", "mean": "sage_cat"}
    name = aliases.get(name, name)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"conv {name!r} (attention or edge features) belongs to the next SAGE slice of the port"
        )
    if name not in _CONVS:
        raise KeyError(f"unknown conv {name!r}; available: {sorted(_CONVS)}")
    return _CONVS[name]
