"""Model registry (port of ``models/registry.py``): name -> constructor, for
the keys this port has. The SAGE family and sasrec are not ported yet."""

from __future__ import annotations

from typing import Callable, Dict

from ..config import Config
from ..data.graph import BipartiteGraph
from .base import PairwiseModel
from .lightgcn import LightGCN
from .mf import MF

__all__ = ["build_model", "available_models"]

_REGISTRY: Dict[str, Callable[..., PairwiseModel]] = {
    "mf": lambda c, g, **kw: MF(c, g, **kw),
    "lgn": lambda c, g, **kw: LightGCN(c, g, norm="sym", **kw),
    "rgcn": lambda c, g, **kw: LightGCN(c, g, norm="sym", **kw),
    "radj": lambda c, g, **kw: LightGCN(c, g, norm="asym", **kw),
    "lgcnssm": lambda c, g, **kw: LightGCN(c, g, norm="sym", loss_mode="softmax", **kw),
}


def build_model(name: str, config: Config, graph: BipartiteGraph, **kw) -> PairwiseModel:
    if name not in _REGISTRY:
        raise KeyError(f"model {name!r} is not in the port; available: {available_models()}")
    return _REGISTRY[name](config, graph, **kw)


def available_models():
    return sorted(_REGISTRY)
