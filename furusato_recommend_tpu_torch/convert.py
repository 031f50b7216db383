"""Parameters across the two packages.

The JAX package keeps a model's parameters as a dict of arrays (for the MF /
LightGCN family ``{"user_emb": [N, d], "item_emb": [M, d]}``); the port keeps
them as ``nn.Parameter``s of the same names on the module.

Adam's state: ``optax.adam`` keeps ``ScaleByAdamState(count, mu, nu)`` with
``mu`` / ``nu`` trees shaped like the parameters; ``torch.optim.Adam`` keeps,
per parameter, ``step``, ``exp_avg`` and ``exp_avg_sq``. The two hold the same
numbers (first and second moments, and the number of steps taken).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["params_from_jax", "params_to_numpy", "adam_state_from_jax", "adam_state_to_numpy"]


def params_from_jax(np_params: Mapping[str, Any], model: nn.Module) -> nn.Module:
    """Copy the JAX parameter dict (numpy arrays, or tensors) into ``model``'s
    parameters of the same names, on the model's device. Every parameter of
    the model must be given, with its shape."""
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


def params_to_numpy(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters as a dict of numpy arrays, the JAX layout."""
    return {name: p.detach().cpu().numpy() for name, p in model.named_parameters()}


def _as_tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))


def adam_state_from_jax(
    count: int,
    mu: Mapping[str, Any],
    nu: Mapping[str, Any],
    optimizer: torch.optim.Adam,
    model: nn.Module,
) -> torch.optim.Adam:
    """Set ``optimizer``'s state for each of ``model``'s parameters from the
    optax moments ``mu`` / ``nu`` (name -> array) after ``count`` steps."""
    own = dict(model.named_parameters())
    if set(mu) != set(own) or set(nu) != set(own):
        raise KeyError(f"moments {sorted(mu)} / {sorted(nu)} do not match the model's {sorted(own)}")
    for name, p in own.items():
        m, v = _as_tensor(mu[name]), _as_tensor(nu[name])
        if tuple(m.shape) != tuple(p.shape) or tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"{name}: moment shapes do not match the parameter's {tuple(p.shape)}")
        optimizer.state[p] = {
            # a host scalar, as torch.optim.Adam keeps it when not capturable
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": m.to(device=p.device, dtype=p.dtype).clone(),
            "exp_avg_sq": v.to(device=p.device, dtype=p.dtype).clone(),
        }
    return optimizer


def adam_state_to_numpy(
    optimizer: torch.optim.Adam, model: nn.Module
) -> Tuple[int, Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(count, mu, nu) in the optax layout; zeros before the first step."""
    count, mu, nu = 0, {}, {}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p)
        if st:
            count = int(st["step"])
            mu[name] = st["exp_avg"].detach().cpu().numpy()
            nu[name] = st["exp_avg_sq"].detach().cpu().numpy()
        else:
            mu[name] = np.zeros(tuple(p.shape), np.float32)
            nu[name] = np.zeros(tuple(p.shape), np.float32)
    return count, mu, nu
