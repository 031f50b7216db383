"""Parameters across the two packages.

The JAX package keeps a model's parameters as a dict of arrays (for the MF /
LightGCN family ``{"user_emb": [N, d], "item_emb": [M, d]}``); the SAGE family
nests its conv layers' dicts in a list, ``{"layers": [{"w": ...}, ...],
...}``, and SASRec two more lists of dicts, ``blocks`` and ``item_tower``.
The port keeps them as ``nn.Parameter``s of the same names on the module, an
entry of such a list as ``{list}.{i}.{name}`` (``flatten_params`` maps the
nested tree to those names, ``nest_params`` back).

Adam's state: ``optax.adam`` keeps ``ScaleByAdamState(count, mu, nu)`` with
``mu`` / ``nu`` trees shaped like the parameters; ``torch.optim.Adam`` keeps,
per parameter, ``step``, ``exp_avg`` and ``exp_avg_sq``. The two hold the same
numbers (first and second moments, and the number of steps taken); the fused
Adam the trainer runs keeps ``step`` as a float32 tensor on the parameter's
device, a plain Adam on the host. The JAX
trainer's partitioned optimizers (``optax.multi_transform`` of ``adam`` and
``set_to_zero``, under ``feature_update_every`` > 1 and the out-of-core
features) keep an Adam state whose moments are ``MaskedNode``s outside its
group; the port keeps one ``torch.optim.Adam`` a group, and
``adam_state_from_jax`` sets only the parameters its optimizer steps.

The re-ranker (``rank/ranker.py``) keeps JAX's flat names too. A ranker
calibrated by the JAX package carries its (beta, gamma, val recall) as a
``_calibration`` leaf among its parameters; the port keeps them beside the
ranker (``ranker_params_from_jax`` returns them, ``ranker_params_to_numpy``
writes them back as that leaf).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = [
    "params_from_jax", "params_to_numpy", "adam_state_from_jax", "adam_state_to_numpy",
    "flatten_params", "nest_params", "ranker_params_from_jax", "ranker_params_to_numpy",
]

CALIBRATION = "_calibration"  # the JAX ranker's (beta, gamma, val recall) leaf


def _is_dict_list(v) -> bool:
    return isinstance(v, (list, tuple)) and all(isinstance(e, Mapping) for e in v)


def flatten_params(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX parameter tree with each top-level list of dicts spelled out
    as ``{list}.{i}.{name}``; a flat dict comes back as it is."""
    flat: Dict[str, Any] = {}
    for key, v in tree.items():
        if _is_dict_list(v):
            for i, entry in enumerate(v):
                flat.update({f"{key}.{i}.{k}": x for k, x in entry.items()})
        else:
            flat[key] = v
    return flat


def nest_params(flat: Mapping[str, Any], lengths: Optional[Mapping[str, int]] = None) -> Dict[str, Any]:
    """Inverse of ``flatten_params``: ``{list}.{i}.{name}`` back into the
    lists of dicts. ``lengths``: list name -> its least number of entries (an
    entry without parameters is an empty dict; a list of length 0 is kept
    empty); a list is present when any name has its form or it is in
    ``lengths``."""
    tree: Dict[str, Any] = {}
    lists: Dict[str, Dict[int, Dict[str, Any]]] = {k: {} for k in (lengths or {})}
    for name, v in flat.items():
        parts = name.split(".", 2)
        if len(parts) == 3 and parts[1].isdigit():
            lists.setdefault(parts[0], {}).setdefault(int(parts[1]), {})[parts[2]] = v
        else:
            tree[name] = v
    for key, entries in lists.items():
        n = max([(lengths or {}).get(key, 0)] + [i + 1 for i in entries])
        tree[key] = [entries.get(i, {}) for i in range(n)]
    return tree


def _list_lengths(model: nn.Module) -> Dict[str, int]:
    """The model's lists of parameter dicts (``nn.ModuleList`` children) and
    their lengths."""
    return {name: len(m) for name, m in model.named_children() if isinstance(m, nn.ModuleList)}


def params_from_jax(np_params: Mapping[str, Any], model: nn.Module) -> nn.Module:
    """Copy the JAX parameter tree (numpy arrays, or tensors; nested as the
    JAX package keeps it, or flat) into ``model``'s parameters of the same
    names, on the model's device. Every parameter of the model must be
    given, with its shape."""
    np_params = flatten_params(np_params)
    own = dict(model.named_parameters())
    if set(np_params) != set(own):
        raise KeyError(f"parameters {sorted(np_params)} do not match the model's {sorted(own)}")
    with torch.no_grad():
        for name, value in np_params.items():
            src = torch.as_tensor(np.asarray(value) if not isinstance(value, torch.Tensor) else value)
            if tuple(src.shape) != tuple(own[name].shape):
                raise ValueError(
                    f"{name}: shape {tuple(src.shape)} != model's {tuple(own[name].shape)}"
                )
            own[name].copy_(src)
    return model


def params_to_numpy(model: nn.Module) -> Dict[str, Any]:
    """The model's parameters as numpy arrays in the JAX layout (a list
    entry's inside its list)."""
    return nest_params(
        {name: p.detach().cpu().numpy() for name, p in model.named_parameters()}, _list_lengths(model)
    )


def _as_tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))


def adam_state_from_jax(
    count: int,
    mu: Mapping[str, Any],
    nu: Mapping[str, Any],
    optimizer: torch.optim.Adam,
    model: nn.Module,
) -> torch.optim.Adam:
    """Set ``optimizer``'s state for each of ``model``'s parameters that it
    steps from the optax moments ``mu`` / ``nu`` (trees like the parameters',
    nested or flat; entries of parameters the optimizer does not step are
    ignored) after ``count`` steps."""
    mu, nu = flatten_params(mu), flatten_params(nu)
    stepped = {id(p) for group in optimizer.param_groups for p in group["params"]}
    # the fused (or capturable) Adam keeps each step count on its parameter's device
    on_device = {id(p) for group in optimizer.param_groups if group["fused"] or group["capturable"]
                 for p in group["params"]}
    own = {name: p for name, p in model.named_parameters() if id(p) in stepped}
    missing = sorted(set(own) - (set(mu) & set(nu)))
    if missing or set(mu) - set(dict(model.named_parameters())):
        raise KeyError(f"moments {sorted(mu)} / {sorted(nu)} do not match the model's {sorted(own)}")
    for name, p in own.items():
        m, v = _as_tensor(mu[name]), _as_tensor(nu[name])
        if tuple(m.shape) != tuple(p.shape) or tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"{name}: moment shapes do not match the parameter's {tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32, device=p.device if id(p) in on_device else "cpu"),
            "exp_avg": m.to(device=p.device, dtype=p.dtype).clone(),
            "exp_avg_sq": v.to(device=p.device, dtype=p.dtype).clone(),
        }
    return optimizer


def adam_state_to_numpy(
    optimizer: torch.optim.Adam, model: nn.Module
) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
    """(count, mu, nu) in the optax layout (nested as ``params_to_numpy``);
    zeros before the first step."""
    count, mu, nu = 0, {}, {}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p)
        if st:
            # a parameter that never had a gradient has no state yet
            count = int(st["step"])
            mu[name] = st["exp_avg"].detach().cpu().numpy()
            nu[name] = st["exp_avg_sq"].detach().cpu().numpy()
        else:
            mu[name] = np.zeros(tuple(p.shape), np.float32)
            nu[name] = np.zeros(tuple(p.shape), np.float32)
    return count, nest_params(mu, _list_lengths(model)), nest_params(nu, _list_lengths(model))


def ranker_params_from_jax(
    np_params: Mapping[str, Any], ranker: nn.Module
) -> Optional[Tuple[float, float, float]]:
    """Copy the JAX ranker's parameter dict into ``ranker`` (as
    ``params_from_jax``); returns its ``_calibration`` leaf as (beta, gamma,
    val recall), or None when it has none."""
    params = dict(np_params)
    cal = params.pop(CALIBRATION, None)
    params_from_jax(params, ranker)
    return None if cal is None else tuple(float(x) for x in np.asarray(cal).reshape(-1))


def ranker_params_to_numpy(
    ranker: nn.Module, calibration: Optional[Tuple[float, float, float]] = None
) -> Dict[str, Any]:
    """The ranker's parameters as the JAX package's dict of numpy arrays,
    with ``calibration`` as its ``_calibration`` leaf when given."""
    out = params_to_numpy(ranker)
    if calibration is not None:
        out[CALIBRATION] = np.asarray(calibration, np.float32)
    return out
