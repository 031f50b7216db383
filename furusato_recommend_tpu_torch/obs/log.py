"""Metric sinks and step timing (port of ``obs/log.py``).

``MetricLogger`` prints each record and fans it out, under the same keys as
the JAX package (``loss``, ``recall@10``, ``cold_recall@10``, ...), to:

- a JSONL file, each record with a timestamp (the trainer's ``metrics.jsonl``);
- a wandb run (``wandb_run``), when ``wandb`` imports and ``wandb.init``
  succeeds; otherwise it prints the JAX package's notice and goes on with the
  file and stdout;
- a tensorboard event file (``tensorboard_dir``) through
  ``torch.utils.tensorboard.SummaryWriter``, with the same fallback when the
  ``tensorboard`` package is missing.

``step_timer`` logs a block's wall-clock seconds as ``time/<name>``.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, Optional

import torch

__all__ = ["MetricLogger", "cprint", "step_timer"]


def cprint(words: str) -> None:
    """Yellow-highlighted print."""
    print(f"\033[0;30;43m{words}\033[0m")


class MetricLogger:
    """stdout, plus an optional JSONL file, wandb run and tensorboard writer."""

    def __init__(
        self,
        jsonl_path: Optional[str | Path] = None,
        wandb_run: Optional[str] = None,
        project: str = "furusato_recommendation",
        quiet: bool = False,
        tensorboard_dir: Optional[str | Path] = None,
    ):
        self.quiet = quiet
        self._jsonl = None
        if jsonl_path:
            p = Path(jsonl_path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(p, "a")
        self._wandb = None
        if wandb_run:
            try:
                import wandb  # optional: not every environment has it

                self._wandb = wandb.init(project=project, name=wandb_run)
            except Exception as e:  # a missing module or a failed init: an optional sink
                print(f"[obs] wandb unavailable ({e}); falling back to jsonl/stdout")
        self._tb = None
        self._tb_step = 0
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(tensorboard_dir))
            except Exception as e:  # the tensorboard package is optional
                print(f"[obs] tensorboard unavailable ({e}); falling back to jsonl/stdout")

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
        if self._wandb:
            self._wandb.log(payload, step=step)
        if self._tb:
            # a record without a step takes the one after the last record's
            s = step if step is not None else self._tb_step
            self._tb_step = s + 1
            for k, v in payload.items():
                if k != "step":
                    self._tb.add_scalar(k, v, global_step=s)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._wandb:
            self._wandb.finish()
            self._wandb = None
        if self._tb:
            self._tb.close()
            self._tb = None


@contextlib.contextmanager
def step_timer(name: str, sink: Optional[MetricLogger] = None, trace: bool = False):
    """Log the block's wall-clock seconds as ``time/<name>`` into ``sink``
    (any object with ``log(metrics)``); with ``trace`` the block is also a
    ``torch.profiler.record_function(name)`` range in a profiler trace.

    Like the JAX package's, the timer does not wait for the device: work the
    block queued on the card and did not wait for falls outside its time."""
    ctx = torch.profiler.record_function(name) if trace else contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx:
        yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink.log({f"time/{name}": dt})
