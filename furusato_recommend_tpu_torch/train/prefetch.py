"""Host -> device prefetch (port of ``train/prefetch.py``).

A thread drains a host iterator and keeps up to ``size`` items already on
the device, so reading and copying the next item overlap the work on the
current one. For a CUDA device each item goes through
pinned host memory and a copy on a side stream; the consumer's stream waits on
an event recorded after the copy, so it never reads a half-copied item and the
host never waits for the card. For the CPU the items are the host arrays as
tensors, in order. An item is an array or tensor, or a tuple, list or dict of
them; an error in the producer is raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

__all__ = ["prefetch_to_device", "BackgroundProducer"]

_POLL_S = 0.1  # how often a blocked producer looks for close()


def _map(item, fn):
    if isinstance(item, (tuple, list)):
        return type(item)(_map(x, fn) for x in item)
    if isinstance(item, dict):
        return {k: _map(v, fn) for k, v in item.items()}
    return fn(item)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


class BackgroundProducer:
    """The items of ``iterable``, drained on a thread and each put on
    ``device`` ahead of ``get()``, at most ``size`` at a time. ``close()``
    stops the thread."""

    def __init__(self, iterable: Iterable, size: int = 2, device=None):
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._done = object()
        self._side = None
        if self.device.type == "cuda":
            self._side = torch.cuda.Stream(device=self.device)
        self._thread = threading.Thread(target=self._run, args=(iter(iterable),), daemon=True)
        self._thread.start()

    def _put(self, entry) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(entry, timeout=_POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def _copy(self, item):
        """(item on the device, the event its copies finish at or None)."""
        if self._side is None:
            return _map(item, _as_tensor), None
        with torch.cuda.stream(self._side):
            out = _map(item, lambda x: _as_tensor(x).pin_memory().to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._side)
        return out, event

    def _run(self, it: Iterator) -> None:
        try:
            for item in it:
                if self._stop.is_set() or not self._put(self._copy(item)):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            self._put((self._done, e))
            return
        self._put((self._done, None))

    def get(self):
        """The next item, on the device; StopIteration after the last."""
        item, event = self._q.get()
        if item is self._done:
            self._thread.join()
            if event is not None:
                raise event
            raise StopIteration
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            # the side stream allocated the item; the consumer's stream uses it
            _map(item, lambda t: t.record_stream(stream))
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=60)


def prefetch_to_device(iterator: Iterable, size: int = 2, device=None) -> Iterator:
    """The items of ``iterator`` on ``device`` (default the CPU), up to
    ``size`` of them read and copied ahead."""
    producer = BackgroundProducer(iterator, size=size, device=device)
    try:
        while True:
            try:
                yield producer.get()
            except StopIteration:
                return
    finally:
        producer.close()
