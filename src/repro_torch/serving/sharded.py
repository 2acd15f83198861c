"""Sharded StreamLoop: the slot batch split over a list of devices.

``serving/stream.py``'s ``StreamLoop`` drives one device and assembles
each step's frames on the host.  This module serves the same engine with
the slot batch split over a list of devices, one process, as the
reference's ``serving/sharded.py`` does over a ``data`` mesh:

  * **Placement.**  ``stream_mesh`` is the device list (every visible
    CUDA device by default).  The weights are replicated: one engine for
    each distinct device, placed with ``CompiledRSNN.place_weights``.  The
    slot batch is split into ``len(devices)`` shards of consecutive slots;
    each shard's state (``distributed.sharding.shard_state``), frame
    buffer and v2 logit ring sit on its device.  No collective runs on the
    step path; the shards' counter accumulators are summed onto the first
    device and cross to the host in one transfer a drain.
  * **Frame buffer.**  Each slot owns a row of its shard's ``(slots / n,
    max_frames, input_dim)`` buffer of pre-quantized frames, written once
    when the slot is filled.  Each step gathers its frames on the device
    by a per-slot cursor and zeroes idle slots, inside the shard's
    captured step; the host sends only the ``(3, [C,] slots / n)`` int32
    control word (cursor, fill mask, ring row) from pinned memory.
  * **Graphs.**  With ``aot_warmup`` each shard's step is captured as one
    CUDA graph at construction, so ``capture_count`` rises by the number
    of shards; every step replays each shard's graph.
  * **Front end.**  ``data.featurize.AsyncFeaturizer`` quantizes
    utterances on a host thread ahead of the loop; ``submit(...,
    quantized=True)`` takes its output as it is, raw frames are quantized
    once, at submit.

Scheduling (queue order, refill, reset on finish, pipeline retirement) is
inherited from ``StreamLoop``, which routes its data path through hooks
(``_build_data_path``, ``_dispatch_step``, ``_dispatch_ring_step``,
``_dispatch_step_chunk``, ``_dispatch_ring_chunk``, ``_reset_slot``,
``_harvest``, ``_aux_total``, ``_zero_aux``); only those are overridden
here, and each shard runs the engine's own step functions, so the logits
are the single-device loop's.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.distributed.sharding import shard_state
from repro_torch.serving.stream import (CompiledRSNN, StreamLoop,
                                        StreamRequest, host_copy,
                                        reset_slot_)


def stream_mesh(devices: Sequence[torch.device | str] | None = None
                ) -> list[torch.device]:
    """The serving devices: ``devices`` (a device may repeat: its shards
    then share it), or every visible CUDA device, raising without a GPU.
    All CUDA or all CPU; a CUDA device without an index is the current
    one."""
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    if not devs or len({d.type for d in devs}) != 1:
        raise ValueError(f"devices must be a nonempty list of CUDA devices "
                         f"or of CPU devices; got {devs}")
    return devs


class _Fence:
    """One event on each distinct CUDA device of a loop, recorded on its
    current stream: the work queued before ``record`` is done once
    ``synchronize`` returns."""

    __slots__ = ("events",)

    def __init__(self, devices: Sequence[torch.device]):
        self.events = [(d, torch.cuda.Event()) for d in devices]

    def record(self) -> None:
        for d, e in self.events:
            e.record(torch.cuda.current_stream(d))

    def synchronize(self) -> None:
        for _, e in self.events:
            e.synchronize()

    def query(self) -> bool:
        return all(e.query() for _, e in self.events)


@dataclasses.dataclass
class _Shard:
    """One shard's device side: its engine (shared by the shards of one
    device), its slot state, frame buffer, ring (v2) and counter
    accumulator (v2 with counters), its control word on the device and its
    bound or captured step."""

    engine: CompiledRSNN
    state: object
    buf: torch.Tensor
    ring: torch.Tensor | None
    aux_acc: torch.Tensor | None
    ctrl: torch.Tensor
    entry: Callable = None

    def guard(self):
        dev = self.engine.device
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())


class ShardedStreamLoop(StreamLoop):
    """Continuous batching over recurrent-state slots split over devices.

    A ``StreamLoop`` whose scheduling is inherited unchanged; only its
    data path is overridden (module docstring).  ``batch_slots`` (by
    default one a device) must be a positive multiple of the number of
    devices; shard k owns slots ``[k b, (k + 1) b)``, ``b = batch_slots /
    n``.  Streams are capped at ``max_frames`` frames, and so is the ring
    (``ring_frames``, 256 by default).  ``shard_states`` and
    ``shard_rings`` expose each shard's tensors.
    """

    def __init__(self, engine: CompiledRSNN, batch_slots: int | None = None,
                 devices: Sequence[torch.device | str] | None = None,
                 max_frames: int = 1024, pipeline_depth: int = 2,
                 ring_frames: int | None = None, track_sparsity: bool = True,
                 chunk_frames: int = 1, aot_warmup: bool = True):
        self.devices = stream_mesh(devices)
        n = len(self.devices)
        slots = batch_slots if batch_slots is not None else n
        if slots < 1 or slots % n != 0:
            raise ValueError(f"batch_slots={slots} must be a positive "
                             f"multiple of the mesh's {n} devices")
        self.max_frames = max_frames
        # streams are capped at max_frames, so the ring never needs more
        ring = min(ring_frames if ring_frames is not None else 256,
                   max_frames)
        super().__init__(engine, batch_slots=slots,
                         pipeline_depth=pipeline_depth, ring_frames=ring,
                         track_sparsity=track_sparsity,
                         chunk_frames=chunk_frames, aot_warmup=aot_warmup)

    # --------------------------------------------------- sharded placement

    def _build_data_path(self) -> None:
        n = len(self.devices)
        b = self._per = self.slots // n
        engines: dict[torch.device, CompiledRSNN] = {}
        for dev in self.devices:  # replicate the weights, once a device
            if dev not in engines:
                eng = self.engine if not engines else copy.copy(self.engine)
                eng.place_weights(dev)
                engines[dev] = eng
        self._cuda = [d for d in engines if d.type == "cuda"]
        cfg, c = self.engine.cfg, self.chunk_frames
        lead = () if c == 1 else (c,)
        v2 = self.pipeline_depth >= 1
        states = shard_state(self.engine.init_state(self.slots), self.devices)
        self._shards = []
        for dev, state in zip(self.devices, states):
            eng = engines[dev]
            sh = _Shard(
                engine=eng, state=state,
                buf=torch.zeros((b, self.max_frames, cfg.input_dim),
                                dtype=torch.float32, device=dev),
                ring=self._init_ring(b, dev) if v2 else None,
                aux_acc=(self._zero_aux_acc(dev)
                         if v2 and self.track_sparsity else None),
                ctrl=torch.zeros((3, *lead, b), dtype=torch.int32,
                                 device=dev))
            self._key, fn = self._contract_fn(eng, b, self._gather_fn(dev))
            with sh.guard():
                sh.entry = self._bind_step(eng, fn, (
                    sh.buf, sh.ctrl, sh.state, sh.ring, sh.aux_acc))
            self._shards.append(sh)
        # the control word goes up through pipeline_depth + 1 pinned words
        # in rotation, each with the fence after which its uploads landed
        shape = (n, 3, *lead, b)
        if self._cuda:
            self._words = [(torch.zeros(shape, dtype=torch.int32,
                                        pin_memory=True), _Fence(self._cuda))
                           for _ in range(self.pipeline_depth + 1)]
        else:
            self._words = [(torch.zeros(shape, dtype=torch.int32), None)]
        self._word_next = 0
        self._rows_in_flight: collections.deque = collections.deque()

    def _gather_fn(self, dev: torch.device) -> Callable:
        """A shard's step inputs from its frame buffer and control word
        (3, [C,] b) [cursor; fill mask; ring row] on ``dev``: each slot's
        frame at its cursor, clipped to ``max_frames - 1``, and zero for
        an idle slot or sub-step.  The frames are already quantized."""
        last = self.max_frames - 1
        rows = torch.arange(self._per, device=dev)

        def frames(buf, ctrl):
            pos, active, ring_idx = ctrl[0], ctrl[1], ctrl[2]
            x = buf[rows, pos.clamp(0, last).long()]
            x = torch.where(active.bool().unsqueeze(-1), x, 0.0)
            return x, active, ring_idx

        return frames

    @property
    def shard_states(self) -> list:
        """Each shard's slot state (``slots / n`` slots on its device)."""
        return [sh.state for sh in self._shards]

    @property
    def shard_rings(self) -> list:
        """Each shard's logit ring, ``(slots / n, ring_frames, fc_dim)`` on
        its device (v2; ``None`` for each shard in v1)."""
        return [None if sh.ring is None else sh.ring[:, :self.ring_frames]
                for sh in self._shards]

    def _shard_of(self, i: int) -> tuple[_Shard, int]:
        return self._shards[i // self._per], i % self._per

    # ------------------------------------------------------------- frontend

    def submit(self, frames: np.ndarray, *, quantized: bool = False) -> int:
        """Queue one utterance.  ``quantized=True`` marks frames already in
        the engine's 8-bit fixed-point format (e.g. from
        ``data.featurize.AsyncFeaturizer``); raw frames are quantized here,
        once, before they enter the frame buffer."""
        frames = self._validate_frames(frames)
        if len(frames) > self.max_frames:
            raise ValueError(
                f"utterance of {len(frames)} frames exceeds the pinned "
                f"buffer ({self.max_frames}); raise max_frames")
        if not quantized and len(frames):
            frames = self.engine.quantize_features(frames).cpu().numpy()
        return self._enqueue(frames)

    def submit_stream(self, utterances: Iterable[np.ndarray], *,
                      quantized: bool = False) -> list[int]:
        """Submit everything an iterable yields, serving while it drains.

        Once the queue backlog covers every slot, engine steps run between
        pulls, so with an ``AsyncFeaturizer`` source (``quantized=True``
        for its output) featurization of later utterances overlaps serving
        of earlier ones; call ``run()`` afterwards to drain.  On an error
        the source's ``close`` (an ``AsyncFeaturizer``'s worker) is
        called before it propagates.
        """
        sids = []
        try:
            for u in utterances:
                sids.append(self.submit(u, quantized=quantized))
                while len(self.queue) >= self.slots:
                    self.step_once()
        except BaseException:
            close = getattr(utterances, "close", None)
            if callable(close):
                close()
            raise
        return sids

    def _on_slot_filled(self, i: int, req: StreamRequest) -> None:
        """Reset the slot, then write its quantized frames into its buffer
        row, on the stream the shard's steps run on, so that the write
        lands after the steps still in flight.  The pinned source is held
        until its copy has landed.  Rows past the utterance are never
        read (a live cursor stays below its length; idle slots are
        zeroed)."""
        super()._on_slot_filled(i, req)
        sh, j = self._shard_of(i)
        src = torch.from_numpy(np.ascontiguousarray(req.frames,
                                                    dtype=np.float32))
        if not sh.buf.is_cuda:
            sh.buf[j, :len(src)].copy_(src)
            return
        while self._rows_in_flight and self._rows_in_flight[0][1].query():
            self._rows_in_flight.popleft()
        src = src.pin_memory()
        with sh.guard():
            sh.buf[j, :len(src)].copy_(src, non_blocking=True)
            landed = _Fence([sh.buf.device])
            landed.record()
        self._rows_in_flight.append((src, landed))

    # ------------------------------------------------------------ step path

    def _reset_slot(self, i: int) -> None:
        sh, j = self._shard_of(i)
        reset_slot_(sh.state, j)

    def _harvest(self, r: StreamRequest, i: int, fill: int) -> None:
        sh, j = self._shard_of(i)
        r.pending.append((host_copy(sh.ring[j, :fill]), fill, self._fence))

    def _dispatch_shards(self, word: np.ndarray) -> list:
        """Upload each shard's part of the (3, [C,] slots) control word
        [cursor; fill mask; ring row] through the next pinned word, then
        run every shard's step; returns their outputs.  On CUDA the step's
        fence is created here (recorded after the harvests)."""
        pinned, landed = self._words[self._word_next]
        self._word_next = (self._word_next + 1) % len(self._words)
        if landed is not None:
            landed.synchronize()
        n, b = len(self._shards), self._per
        pinned.numpy()[:] = np.moveaxis(
            word.reshape(*word.shape[:-1], n, b), -2, 0)
        outs = []
        for k, sh in enumerate(self._shards):
            with sh.guard():
                sh.ctrl.copy_(pinned[k], non_blocking=landed is not None)
                outs.append(sh.entry())
        if landed is not None:
            landed.record()
            if self.pipeline_depth >= 1:
                self._fence = _Fence(self._cuda)
        return outs

    def _cursors(self) -> np.ndarray:
        """Each sub-step's frame cursor, (C, slots) (or (slots,) at C = 1):
        the slot's cursor plus the sub-step; idle sub-steps' cursors are
        clipped on the device and masked."""
        pos = np.asarray(self.slot_pos, np.int32)
        if self.chunk_frames == 1:
            return pos
        return pos + np.arange(self.chunk_frames, dtype=np.int32)[:, None]

    def _word(self, mask: np.ndarray, ring_rows=0) -> np.ndarray:
        word = np.empty((3, *mask.shape), np.int32)
        word[0] = self._cursors()
        word[1] = mask
        word[2] = ring_rows
        return word

    def _v1(self, word: np.ndarray):
        """A v1 step: the shards' logits joined on the host along the slot
        axis and their counter vectors summed on the first device."""
        outs = self._dispatch_shards(word)
        logits = np.concatenate([lg.cpu().numpy() for lg, _ in outs], -2)
        return logits, self._sum_first([v for _, v in outs])

    def _dispatch_step(self, active: np.ndarray):
        return self._v1(self._word(active))

    def _dispatch_step_chunk(self, counts: list[int], act: np.ndarray):
        return self._v1(self._word(act))

    def _dispatch_ring_step(self, ctrl: np.ndarray) -> None:
        self._dispatch_shards(self._word(ctrl[0], ctrl[1]))

    def _dispatch_ring_chunk(self, counts: list[int],
                             ctrl: np.ndarray) -> None:
        self._dispatch_shards(self._word(ctrl[0], ctrl[1]))

    # ------------------------------------------------------------- counters

    @staticmethod
    def _sum_first(vecs: list[torch.Tensor]) -> torch.Tensor:
        total = vecs[0].clone()
        for v in vecs[1:]:
            total += v.to(total.device)
        return total

    def _aux_total(self) -> torch.Tensor:
        return self._sum_first([sh.aux_acc for sh in self._shards])

    def _zero_aux(self) -> None:
        for sh in self._shards:
            if sh.aux_acc is not None:
                sh.aux_acc.zero_()
