"""Walker alias tables: O(1) categorical draws on the device (port of
``ops/alias.py``).

They give the BPR sampler its weighted recipes: edge draws with capped or
popularity-tilted weights (the ddp recipe, ``--sample_pow``) and
popularity^pow negatives. The table is built on the host by the JAX package's
numpy Walker construction, step for step, so ``prob`` (float32) and ``alias``
(int32) are bit-equal to its; a draw is a uniform slot, a uniform number and
a select, from a ``torch.Generator`` on the table's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["AliasTable", "build_alias_table"]


@dataclass(frozen=True)
class AliasTable:
    prob: torch.Tensor  # [N] float32: acceptance probability of the home slot
    alias: torch.Tensor  # [N] int32: the outcome otherwise

    @property
    def n(self) -> int:
        return self.prob.shape[0]

    def to(self, device) -> "AliasTable":
        return AliasTable(self.prob.to(device), self.alias.to(device))

    def sample(self, generator: torch.Generator, shape) -> torch.Tensor:
        """int64 outcomes in [0, n) of the given shape."""
        dev = self.prob.device
        slot = torch.randint(0, self.n, tuple(shape), generator=generator, device=dev)
        u = torch.rand(tuple(shape), generator=generator, device=dev)
        return torch.where(u < self.prob[slot], slot, self.alias[slot].long())


def build_alias_table(weights: np.ndarray) -> AliasTable:
    """The standard Walker construction (host, numpy), as CPU tensors."""
    w = np.asarray(weights, dtype=np.float64)
    if np.any(w < 0):
        raise ValueError("alias weights must be non-negative")
    total = w.sum()
    if total <= 0:
        raise ValueError("alias weights must not all be zero")
    n = len(w)
    p = w * (n / total)
    prob = np.zeros(n, dtype=np.float64)
    alias = np.zeros(n, dtype=np.int64)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        big = large.pop()
        prob[s] = p[s]
        alias[s] = big
        p[big] = p[big] - (1.0 - p[s])
        (small if p[big] < 1.0 else large).append(big)
    for i in large:
        prob[i] = 1.0
    for i in small:
        prob[i] = 1.0
    return AliasTable(
        prob=torch.from_numpy(prob.astype(np.float32)),
        alias=torch.from_numpy(alias.astype(np.int32)),
    )
