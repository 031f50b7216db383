"""Model registry (port of ``models/registry.py``): name -> constructor, for
the keys this port has. The SAGE-family keys need ``features=`` (a
``FeatureStore``); ``dask`` is ``textsage`` with out-of-core numeric features
(``ooc_numeric={side: MemmapNumeric}``, ``data/ooc.py``); ``tgrec`` and
``tgrec2`` are the SAGE model with the ``transformer`` and
``transformer_cat`` convs, ``gnn`` takes its conv from ``--conv``. The
edge-feature keys: ``tgsrec`` (``temporal``) and ``sasgnn`` (``recency``)
read ``features.edge_time``, ``rsage`` (``relational_{--multi_relational}``)
needs ``features.edge_label``. ``sasrec`` (``models/sasrec.py``) also needs
``sequences=`` (``data/sequence.py``); ``asage`` (``models/asage.py``) takes
its attribute graphs as ``user_attr=`` / ``item_attr=`` COO pairs, else
derives them from the categorical features. Every key of the JAX package's
registry is here."""

from __future__ import annotations

from typing import Callable, Dict

from ..config import Config
from ..data.graph import BipartiteGraph
from .base import PairwiseModel
from .lightgcn import LightGCN
from .mf import MF

__all__ = ["build_model", "available_models", "SAGE_KEYS"]


def _sage(conv=None, **fixed):
    def make(c, g, features=None, **kw):
        from .sage import SAGE

        if features is None:
            raise ValueError("SAGE-family models require features=FeatureStore(...)")
        # the gnn key takes its conv from --conv
        return SAGE(c, g, features, conv=c.conv if conv is None else conv, **{**fixed, **kw})

    return make


def _rsage(c, g, features=None, **kw):
    """Multi-relational SAGE: the relation combine from --multi_relational;
    needs the message graph's labels in ``features.edge_label``."""
    from .sage import SAGE

    if features is None:
        raise ValueError("rsage requires features=FeatureStore(...)")
    if features.edge_label is None:
        raise ValueError(
            "rsage needs features.edge_label (favorite_train / review_train csvs through "
            "data.graph.build_relational_graph, or synthetic labels)"
        )
    return SAGE(c, g, features, conv=f"relational_{c.multi_relational}", **kw)


def _sasrec(c, g, features=None, sequences=None, **kw):
    """The sequence model: item features, user item sequences."""
    from .sasrec import SASRec

    if features is None or sequences is None:
        raise ValueError("sasrec requires features= and sequences=")
    return SASRec(c, g, features, sequences, **kw)


def _asage(c, g, features=None, **kw):
    from .asage import ASAGE

    if features is None:
        raise ValueError("asage requires features=FeatureStore(...)")
    return ASAGE(c, g, features, **kw)


_REGISTRY: Dict[str, Callable[..., PairwiseModel]] = {
    "mf": lambda c, g, **kw: MF(c, g, **kw),
    "lgn": lambda c, g, **kw: LightGCN(c, g, norm="sym", **kw),
    "rgcn": lambda c, g, **kw: LightGCN(c, g, norm="sym", **kw),
    "radj": lambda c, g, **kw: LightGCN(c, g, norm="asym", **kw),
    "lgcnssm": lambda c, g, **kw: LightGCN(c, g, norm="sym", loss_mode="softmax", **kw),
    "textsage": _sage("sage_cat"),
    "dask": _sage("sage_cat"),
    "textsage_id": _sage("sage_cat", use_id_embedding=True),
    "sage": _sage("sage_cat", use_id_embedding=True),
    "fsage": _sage("sage_cat", use_id_embedding=True),
    "fastsage": _sage("sage_w2"),
    "lightsage": _sage("light"),
    "pinsage": _sage("pinsage"),
    "mrec": _sage("sage_cat", towers=True),
    "nssage": _sage("sage_cat", full_graph_train=True),
    "gnn": _sage(),
    "tgrec": _sage("transformer"),
    "tgrec2": _sage("transformer_cat"),
    "tgsrec": _sage("temporal"),
    "sasgnn": _sage("recency"),
    "rsage": _rsage,
    "sasrec": _sasrec,
    "asage": _asage,
}

#: the keys whose models take features (build_model_inputs loads them)
SAGE_KEYS = frozenset(k for k in _REGISTRY if k not in ("mf", "lgn", "rgcn", "radj", "lgcnssm"))


def build_model(name: str, config: Config, graph: BipartiteGraph, **kw) -> PairwiseModel:
    if name not in _REGISTRY:
        raise KeyError(f"model {name!r} is not in the port; available: {available_models()}")
    return _REGISTRY[name](config, graph, **kw)


def available_models():
    return sorted(_REGISTRY)
