"""Host data pipeline: background prefetch + device placement.

A prefetch thread keeps `depth` batches in flight (overlapping host data
work with device compute) and puts each batch's arrays on the trainer's
device. Streams are seekable by step, so resume-after-failure replays the
exact batch sequence.

The reference's ``data/pipeline.py`` on one device: ``device=`` (default
``cuda``, raising without a GPU) takes the place of the reference's
``sharding=``.  A batch that fails to build raises from ``__next__``
instead of leaving the consumer waiting.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.tree import tree_map


class PrefetchIterator:
    def __init__(self, make_batch: Callable[[int], dict], start_step: int = 0,
                 depth: int = 2, device: torch.device | str = "cuda"):
        self._make = make_batch
        self._device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))  # a copy the batch cannot alias
        return x.to(self._device)

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, tree_map(self._put, self._make(step)))
            except Exception as e:  # raised again by __next__
                item = (step, e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(item[1], Exception):
                return
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        if isinstance(batch, Exception):
            raise batch
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
