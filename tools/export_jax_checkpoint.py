#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package into one of the PyTorch port.

    python3 tools/export_jax_checkpoint.py --ckpt checkpoints/textsage/32_2__run.ckpt --out run.npz

``--ckpt`` is a JAX checkpoint: the ``.ckpt`` file of the npz backend (a
pickle of a JAX tree definition, the leaves' npz bytes and the config JSON)
or the directory of the orbax backend; reading either needs JAX, so this
script runs where the JAX package does (not on the card's machine) and sits
outside both packages. It writes the port's ``.npz``
(``furusato_recommend_tpu_torch.core.checkpoint``):

- the parameters, each list entry of the JAX tree as ``{list}.{i}.{name}``
  (``convert.flatten_params``), and the config;
- where the JAX state has them (a ``Trainer.save`` checkpoint), each Adam's
  step count and moments under the port trainer's keys: ``adam_count``,
  ``adam_mu/<name>``, ``adam_nu/<name>`` for the optimizer that steps every
  step, ``feat_adam_*`` for the feature parameters' under
  ``feature_update_every`` > 1 (zeros for a parameter outside an optimizer's
  group), and ``step`` and ``max_recall``, so the port's ``Trainer.restore``
  resumes from the file.

JAX's threefry key cannot be carried into a ``torch.Generator``: the file has
no ``generator`` state, and ``Trainer.restore`` starts the sampler's stream
from ``config.seed``.

A ranker checkpoint of the JAX package's ``tools train-ranker`` (``{"params":
...}``, no optimizer state) exports as its parameters and config; a
calibrated ranker's ``_calibration`` leaf goes along as one of them, and the
port's ``tools rerank-eval`` reads it through
``convert.ranker_params_from_jax``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from furusato_recommend_tpu.core.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from furusato_recommend_tpu_torch.config import Config  # noqa: E402
from furusato_recommend_tpu_torch.convert import flatten_params  # noqa: E402
from furusato_recommend_tpu_torch.core.checkpoint import save_checkpoint  # noqa: E402
from furusato_recommend_tpu_torch.train.trainer import OPTIMIZER_PREFIXES  # noqa: E402

__all__ = ["adam_states", "export", "main"]


def _is_adam(x) -> bool:
    """An optax ``ScaleByAdamState``, or the plain mapping orbax restores it as."""
    if hasattr(x, "_fields"):
        return set(x._fields) == {"count", "mu", "nu"}
    return isinstance(x, dict) and set(x) == {"count", "mu", "nu"}


def _field(x, name):
    return x[name] if isinstance(x, dict) else getattr(x, name)


def adam_states(opt_state) -> List[Any]:
    """Every Adam state in ``opt_state``, in the order of the tree: a single
    ``optax.adam``, the groups of an ``optax.multi_transform``, and the
    (every-step, feature) pair of the trainer under ``feature_update_every``
    > 1."""
    found: List[Any] = []

    def walk(x):
        if _is_adam(x):
            found.append(x)
        elif isinstance(x, dict):
            keys = sorted(x, key=lambda k: (0, int(k)) if str(k).isdigit() else (1, str(k)))
            for k in keys:
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for e in x:
                walk(e)

    walk(opt_state)
    return found


def _masked(x) -> bool:
    """optax's ``MaskedNode`` (a parameter outside a ``multi_transform``
    group), as the npz backend restores it, or the None orbax gives for it."""
    return x is None or type(x).__name__ == "MaskedNode"


def _moments(tree, params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The moment tree flattened as the parameters, with zeros for a
    parameter that is masked out of the optimizer's group or absent from the
    tree; any other leaf must be a float array of the parameter's shape."""
    flat = flatten_params(tree)
    out = {}
    for name, p in params.items():
        if name not in flat or _masked(flat[name]):
            out[name] = np.zeros(p.shape, np.float32)
            continue
        a = np.asarray(flat[name])
        if a.shape != p.shape or a.dtype.kind != "f":
            raise ValueError(f"the moment of {name!r} is {a.dtype} {a.shape}; "
                             f"the parameter is {p.dtype} {p.shape}")
        out[name] = a.astype(np.float32)
    return out


def export(ckpt: str, out: str) -> Dict[str, Any]:
    """Write the port's checkpoint of the JAX checkpoint ``ckpt`` to ``out``;
    returns a summary (parameters, optimizers and the state keys written)."""
    state = jax_load_checkpoint(ckpt)
    cfg_json: Optional[dict] = state.get("__config__")
    config = Config.from_json(json.dumps(cfg_json)) if cfg_json else Config()
    params = {k: np.asarray(v) for k, v in flatten_params(state["params"]).items()}
    extra: Dict[str, Any] = {}
    adams = adam_states(state["opt_state"]) if "opt_state" in state else []
    if len(adams) > len(OPTIMIZER_PREFIXES):
        raise ValueError(f"{len(adams)} Adam states in {ckpt}; the port's trainer keeps at most 2")
    for prefix, adam in zip(OPTIMIZER_PREFIXES, adams):
        extra[f"{prefix}_count"] = np.int64(np.asarray(_field(adam, "count")))
        for which in ("mu", "nu"):
            m = _moments(_field(adam, which), params)
            extra.update({f"{prefix}_{which}/{k}": v for k, v in m.items()})
    if "step" in state:
        extra["step"] = np.int64(np.asarray(state["step"]))
    if "max_recall" in state:
        extra["max_recall"] = np.float64(np.asarray(state["max_recall"]))
    if adams or "step" in state:
        extra.setdefault("step", np.int64(0))
        extra.setdefault("max_recall", np.float64(-1.0))
    save_checkpoint(out, params, config, extra)
    return {"params": sorted(params), "optimizers": list(OPTIMIZER_PREFIXES[: len(adams)]),
            "state": sorted(k for k in extra if "/" not in k)}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description="JAX checkpoint -> the PyTorch port's .npz")
    ap.add_argument("--ckpt", required=True, help="a JAX .ckpt file (npz backend) or orbax directory")
    ap.add_argument("--out", required=True, help="the port's checkpoint to write")
    args = ap.parse_args(argv)
    summary = export(args.ckpt, args.out)
    print(f"wrote {args.out}: {len(summary['params'])} parameters, optimizers {summary['optimizers']}, "
          f"state {summary['state']}")
    return summary


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")  # reading a checkpoint needs no accelerator
    main()
