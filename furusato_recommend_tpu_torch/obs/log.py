"""Metric sinks (port of ``obs/log.py``).

``MetricLogger`` prints each record and appends it, with a timestamp, to a
JSONL file (the trainer's ``metrics.jsonl``), under the same keys as the JAX
package (``loss``, ``recall@10``, ``cold_recall@10``, ...). The JAX package's
wandb and tensorboard sinks are not ported.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

__all__ = ["MetricLogger", "cprint"]


def cprint(words: str) -> None:
    """Yellow-highlighted print."""
    print(f"\033[0;30;43m{words}\033[0m")


class MetricLogger:
    """stdout and an optional JSONL file."""

    def __init__(self, jsonl_path: Optional[str | Path] = None, quiet: bool = False):
        self.quiet = quiet
        self._jsonl = None
        if jsonl_path:
            p = Path(jsonl_path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(p, "a")

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        payload = {k: float(v) for k, v in metrics.items()}
        if step is not None:
            payload["step"] = step
        if not self.quiet:
            short = {k: round(v, 6) for k, v in payload.items()}
            print(f"[metrics] {short}")
        if self._jsonl:
            self._jsonl.write(json.dumps({"ts": time.time(), **payload}) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None

