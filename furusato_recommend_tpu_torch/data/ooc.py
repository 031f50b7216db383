"""Out-of-core numeric features, the ``dask`` variant (port of ``data/ooc.py``).

The raw [N, Fn] numeric matrix stays on disk, opened as a read-only numpy
memmap (``MemmapNumeric``); the model holds only its projection ``X @ W + b``
([N, d]) on the device. The trainer recomputes that projection once an epoch
(``stream_project``: row chunks copied to the device ahead of the product by
``train/prefetch.py``), accumulates its table gradient G on the device over the
epoch, and updates the numeric linear after the epoch from a second streamed
pass, ``X^T G`` and the column sums of G (``stream_project_grad``). The
products are plain matrix products, as they are in the JAX package, where no
Pallas kernel computes them.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..train.prefetch import prefetch_to_device

__all__ = ["MemmapNumeric", "stream_project", "stream_project_grad"]

#: rows a streamed chunk takes (the JAX package's default)
CHUNK = 65536


class MemmapNumeric:
    """A float32 [N, Fn] matrix in an ``.npy`` file, opened as a read-only
    memmap; rows are read from disk only by ``chunk``."""

    def __init__(self, path: str):
        self.path = str(path)
        self._mm = np.load(self.path, mmap_mode="r")
        if self._mm.ndim != 2:
            raise ValueError(f"{path}: expected a 2-D numeric matrix, got {self._mm.shape}")

    @staticmethod
    def write(path: str, array: np.ndarray) -> "MemmapNumeric":
        """Save ``array`` as float32 to ``path`` (``.npy`` appended when
        missing) and open it."""
        np.save(path, np.ascontiguousarray(np.asarray(array, dtype=np.float32)))
        p = str(path)
        return MemmapNumeric(p if p.endswith(".npy") else p + ".npy")

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self._mm.shape)

    def chunk(self, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) as a new float32 array (the only disk read)."""
        return np.array(self._mm[lo:hi], dtype=np.float32)

    def iter_chunks(self, chunk: int) -> Iterator[np.ndarray]:
        n = self.shape[0]
        for lo in range(0, n, chunk):
            yield self.chunk(lo, min(lo + chunk, n))


def stream_project(mm: MemmapNumeric, w: torch.Tensor, b: torch.Tensor, chunk: int = CHUNK,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, d] = X @ w + b on w's device, over row chunks of X; chunk i + 1 is
    read and copied while chunk i's product runs. ``out``: the [N, d]
    float32 tensor to write into (a new one otherwise)."""
    n = mm.shape[0]
    if out is None:
        out = torch.empty((n, w.shape[1]), dtype=torch.float32, device=w.device)
    elif tuple(out.shape) != (n, w.shape[1]) or out.dtype != torch.float32:
        raise ValueError(f"out is {tuple(out.shape)} {out.dtype}, the projection ({n}, {w.shape[1]}) float32")
    lo = 0
    for xc in prefetch_to_device(mm.iter_chunks(min(chunk, n)), size=2, device=w.device):
        hi = lo + xc.shape[0]
        out[lo:hi] = xc @ w + b
        lo = hi
    return out


def stream_project_grad(mm: MemmapNumeric, g: torch.Tensor, chunk: int = CHUNK):
    """(grad_w [Fn, d], grad_b [d]) of sum(g * (X @ w + b)): X^T g over row
    chunks of X, and the column sums of g; on g's device."""
    n, fn = mm.shape
    gw = torch.zeros((fn, g.shape[1]), dtype=torch.float32, device=g.device)
    lo = 0
    for xc in prefetch_to_device(mm.iter_chunks(min(chunk, n)), size=2, device=g.device):
        hi = lo + xc.shape[0]
        gw += xc.T @ g[lo:hi]
        lo = hi
    return gw, g.sum(dim=0)
