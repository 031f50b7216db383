"""Parameters across the two packages.

The JAX package keeps a model's parameters as a dict of arrays (for the MF /
LightGCN family ``{"user_emb": [N, d], "item_emb": [M, d]}``); the port keeps
them as ``nn.Parameter``s of the same names on the module.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["params_from_jax", "params_to_numpy"]


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
