"""Checkpoints of the port (counterpart of ``core/checkpoint.py``).

The format is the port's own: one ``.npz`` holding each parameter array under
``param/<name>``, any further training state (optimizer moments, the sampler's
generator state, the step and the best metric) under ``state/<name>``, and the
config JSON under ``__config__``, read back without pickle. The JAX package's
``.npz`` checkpoints pickle a JAX tree definition, so reading one needs JAX;
the port does not read them yet.

``checkpoint_path`` is the JAX package's path scheme,
``{path}/{model}/{latent_dim}_{n_layers}_{suffix}_{run}.ckpt``.
"""

from __future__ import annotations

import io
import json
import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..config import Config

__all__ = ["save_checkpoint", "load_checkpoint", "checkpoint_path"]

_PREFIX = "param/"
_STATE = "state/"


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def checkpoint_path(config: Config, run_name: str = "") -> Path:
    base = Path(config.path) / config.model
    run = run_name or config.wandb or "run"
    if config.for_lgbm:
        name = f"{config.latent_dim}_{config.n_layers}_{config.suffix}_{config.lgbm_ratio}_{run}.ckpt"
    else:
        name = f"{config.latent_dim}_{config.n_layers}_{config.suffix}_{run}.ckpt"
    return base / name


def save_checkpoint(
    path: str | Path,
    params: Mapping[str, Any],
    config: Optional[Config] = None,
    state: Optional[Mapping[str, Any]] = None,
) -> None:
    """Write ``params`` (name -> array or tensor), the optional training
    ``state`` (name -> array, tensor or number) and ``config`` to ``path``,
    atomically: a temporary file renamed over the target."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {_PREFIX + name: _to_numpy(v) for name, v in params.items()}
    arrays.update({_STATE + name: _to_numpy(v) for name, v in (state or {}).items()})
    arrays["__config__"] = np.array((config or Config()).to_json())
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(buf.getvalue())
    os.replace(tmp, path)


def load_checkpoint(path: str | Path) -> Dict[str, Any]:
    """{"params": {name: np.ndarray}, "state": {name: np.ndarray},
    "__config__": dict} of a checkpoint written by ``save_checkpoint``."""
    with np.load(Path(path), allow_pickle=False) as z:
        params = {k[len(_PREFIX):]: z[k] for k in z.files if k.startswith(_PREFIX)}
        state = {k[len(_STATE):]: z[k] for k in z.files if k.startswith(_STATE)}
        config = json.loads(str(z["__config__"]))
    return {"params": params, "state": state, "__config__": config}
