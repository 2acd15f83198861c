"""Async featurization front end for the streaming slot loops.

The serving path is: raw audio features -> static 8-bit fixed-point
quantization -> slot loop.  The quantization is elementwise with a static
calibrated scale, so it can run ahead of the engine on a host thread: a
background thread keeps ``depth`` quantized utterances in flight while the
slot loop steps the engine, so a refilled slot never waits on
featurization.

With the pipelined (v2) slot loops, up to ``pipeline_depth`` device steps
are in flight on top of the ``batch_slots`` streams being served, so a
refill can be demanded ``pipeline_depth`` dispatches before the completing
step has finished on the device.  ``prefetch_depth`` sizes the queue for
that, and ``AsyncFeaturizer.for_loop`` builds a front end sized for a
loop, whose default featurizer quantizes on the CPU with the port's
``core.spike_ops.quantize_input`` and the engine's scale: the worker
thread never touches the card.

The quantizer is elementwise and deterministic, so feeding pre-quantized
frames (``submit(..., quantized=True)`` of ``serving/sharded.py``) gives
the logits of the engine quantizing the frames itself.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch.core import spike_ops

_DONE = object()


def prefetch_depth(batch_slots: int, pipeline_depth: int = 2,
                   chunk_frames: int = 1) -> int:
    """Prefetch depth that keeps a pipelined slot loop fed.

    One quantized utterance ready per slot, plus one per in-flight device
    step so a refill demanded at dispatch time never waits on the worker:

    >>> prefetch_depth(4, 2)
    6
    >>> prefetch_depth(1, 0)  # synchronous v1 loop: still double-buffered
    2

    A chunked loop (``chunk_frames=C > 1``) retires up to a whole chunk of
    frames per slot per dispatch, so in the worst case (short utterances)
    every in-flight dispatch can complete a stream in every slot: the
    queue covers ``slots * (pipeline_depth + 1) * C``:

    >>> prefetch_depth(2, 2, chunk_frames=4)
    24
    >>> prefetch_depth(4, 2, chunk_frames=1)  # C=1 keeps the v2 sizing
    6
    """
    base = max(batch_slots + max(pipeline_depth, 1), 2)
    if chunk_frames <= 1:
        return base
    return max(base, batch_slots * (pipeline_depth + 1) * chunk_frames)


def cpu_quantizer(engine) -> Callable[[np.ndarray], np.ndarray]:
    """The engine's static-scale 8-bit input quantizer, run on the CPU:
    ``core.spike_ops.quantize_input`` with ``engine``'s scale (copied to
    the host once), float32 in and out; the identity for an engine whose
    features arrive integer-valued (``input_scale=None``)."""
    bits = engine.cfg.input_bits
    scale = (None if engine._input_scale is None
             else engine._input_scale.detach().cpu())

    def featurize(u: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(u, dtype=np.float32))
        if scale is None:
            return x.numpy()
        return spike_ops.quantize_input(x, bits, scale)[0].numpy()

    return featurize


class AsyncFeaturizer:
    """Background thread that featurizes/quantizes utterances ahead of use.

    ``featurize`` maps one raw utterance ``(T, input_dim)`` to the
    quantized frames the engine consumes (``cpu_quantizer(engine)``).
    Iteration yields utterances in submission order; ``close()`` stops the
    worker early (e.g. on error in the consuming loop).
    """

    @classmethod
    def for_loop(cls, loop, utterances: Iterable[np.ndarray],
                 featurize: Callable[[np.ndarray], np.ndarray] | None = None,
                 depth: int | None = None) -> "AsyncFeaturizer":
        """Front end sized for a slot loop: ``depth`` defaults to
        ``prefetch_depth(loop.slots, loop.pipeline_depth,
        loop.chunk_frames)`` and ``featurize`` to the loop engine's
        quantizer on the CPU (``cpu_quantizer``; feed the result to
        ``submit``/``submit_stream`` with ``quantized=True``)."""
        if featurize is None:
            featurize = cpu_quantizer(loop.engine)
        if depth is None:
            depth = prefetch_depth(loop.slots, loop.pipeline_depth,
                                   getattr(loop, "chunk_frames", 1))
        return cls(utterances, featurize, depth=depth)

    def __init__(self, utterances: Iterable[np.ndarray],
                 featurize: Callable[[np.ndarray], np.ndarray],
                 depth: int = 4):
        self._featurize = featurize
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._worker, args=(iter(utterances),), daemon=True)
        self._thread.start()

    def _worker(self, it: Iterator[np.ndarray]) -> None:
        try:
            for utt in it:
                if self._stop.is_set():
                    return
                out = np.asarray(self._featurize(np.asarray(utt)))
                while not self._stop.is_set():
                    try:
                        self._q.put(out, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_DONE, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        # poll so that a close() from any thread ends iteration instead of
        # leaving a consumer blocked on a queue that will never be fed
        while True:
            if self._stop.is_set():
                # exhaustion and errors are latched: the _DONE sentinel
                # crosses the queue once, so a later next() must not wait
                # for it again
                if self._err is not None:
                    raise self._err
                raise StopIteration
            try:
                item = self._q.get(timeout=0.5)
            except queue.Empty:
                continue
            if item is _DONE:
                self._stop.set()  # latch: every later next() short-circuits
                if self._err is not None:
                    raise self._err
                raise StopIteration
            return item

    def close(self) -> None:
        """Stop and join the worker (idempotent; also latched by
        exhaustion).  Drains the queue so that a worker blocked on ``put``
        sees the stop, then joins it, so no featurization outlives the
        consumer.  A pending worker error stays latched for
        ``__next__``."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
