"""Streaming compressed-RSNN inference engine (frames -> slots -> state).

The serving path for the paper's workload: always-on speech recognition
over 10-ms audio frames, from the pruned int4 model or the float one
(``EngineConfig.precision``, ``"float"`` by default as in the reference).

1. **Frames.** Audio arrives as per-utterance feature sequences
   ``(T, input_dim)``, quantized to the 8-bit fixed-point input format with
   a static calibrated scale (``quantize_features``).
2. **Slots.** ``StreamLoop`` packs N concurrent utterances into a fixed
   batch of ``batch_slots`` slots.  Every step advances each active slot by
   one frame (or by up to ``chunk_frames`` frames); a finished slot has its
   recurrent state zeroed in place (``reset_slot_``) and is refilled from
   the queue without stopping the batch.
3. **State.** ``CompiledRSNN`` carries ``RSNNState`` (per-ts spikes + LIF
   membrane chain) across frames, wrapped in ``DeltaRSNNState`` (held
   input, cached L0 pre-activation) when the backend gates its input.
   Each frame is the L0 cell, the L1 cell and the FC readout, composed
   from the op table that the backend registry (``serving/backends.py``)
   resolved at construction, or, for ``fused``/``fused_spike``, one
   mega-step launch that does all three (``CompiledRSNN._chunk_step``
   runs F frames in one).

4. **Contracts.** ``pipeline_depth=0`` is the reference's synchronous v1
   contract: one logit fetch and one counter fetch a step.  ``>= 1`` is
   the pipelined v2 contract: each step writes its logits into a device
   ring (``(slots, ring_frames, fc_dim)``, in place) and adds its packed
   counters into a device accumulator; at most ``pipeline_depth`` steps
   are in flight, retired on a fence (a ``torch.cuda.Event``), and a
   stream's logits cross to the host once, on completion or at a
   ring-watermark flush.  ``chunk_frames=C`` advances every slot by up to
   C frames in one dispatch (one K6/K7 launch for ``fused*``).  Scheduling
   and logits are the same in every contract, bit for bit.
5. **Graphs.** The loop allocates its state, ring, accumulator and step
   inputs once and only writes into them.  With ``aot_warmup=True`` on a
   CUDA engine it warms its step up and captures it as one CUDA graph,
   which every step then replays: the port's counterpart of the
   reference's donated, ahead-of-time compiled step.

Entry points (``CompiledRSNN``, ``CompiledRSNN.from_artifact``,
``StreamLoop`` through its engine) run on ``device="cuda"`` unless the
caller asks for ``device="cpu"``; with no GPU present the default raises.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import complexity
from repro_torch.core import lif as lif_lib
from repro_torch.core import rsnn, spike_ops
from repro_torch.core.device import resolve_device
from repro_torch.core.layouts.nm import NMGroupPacked, entry_rows
from repro_torch.core.lif import LIFParams, LIFState
from repro_torch.core.rsnn import RSNNConfig, RSNNState
from repro_torch.core.compression.compress import (CompressionConfig,
                                                   CompressionState,
                                                   init_compression)
from repro_torch.core.sparse import (PackedRSNN, SparseColumns, dequantize,
                                     pack_model)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.serving import backends
from repro_torch.serving.slots import SlotScheduler

WARMUP_STEPS = 2  # eager steps on scratch buffers before a graph capture


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution-path selection for CompiledRSNN."""

    backend: str = "jnp"  # registered name in serving/backends.py
    precision: str = "float"  # "float" (raw params) | "int4" (packed model)
    sparse_fc: bool = False  # zero-skip layout path for the pruned FC
    input_scale: float | torch.Tensor | None = None  # static 8-bit calibration
    delta_threshold: float = 0.0  # delta backend: |x_t - x_prev| gate (LSBs)
    spike_capacity: int | None = None  # spike/delta: event-list slots per
    # row (None = sized to the contraction dim, lossless; smaller values
    # model a finite hardware event queue and drop each row's
    # highest-index spike events)

    def __post_init__(self):
        if self.backend not in backends.available():
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"available: {backends.available()}")
        if self.precision not in ("float", "int4"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.wants_sparse_fc and self.precision != "int4":
            raise ValueError("the zero-skip layout FC runs over the packed "
                             "int4 model (set precision='int4')")
        if self.delta_threshold < 0.0:
            raise ValueError(
                f"delta_threshold must be >= 0, got {self.delta_threshold}")
        if self.delta_threshold != 0.0 and self.backend != "delta":
            raise ValueError(
                "delta_threshold is the 'delta' backend's knob; backend "
                f"{self.backend!r} would silently ignore it")
        if self.spike_capacity is not None:
            if self.spike_capacity < 1:
                raise ValueError(
                    f"spike_capacity must be >= 1, got {self.spike_capacity}")
            if self.backend not in ("spike", "delta"):
                raise ValueError(
                    "spike_capacity is the event-queue knob of the 'spike'"
                    " and 'delta' backends; backend "
                    f"{self.backend!r} would silently ignore it")

    @property
    def wants_sparse_fc(self) -> bool:
        """The zero-skip readout: the flag, or the dedicated backend."""
        return self.sparse_fc or self.backend == "sparse"


def calibrate_input_scale(features: torch.Tensor, bits: int = 8
                          ) -> torch.Tensor:
    """Static input quantization scale from calibration audio (max-abs)."""
    return spike_ops.quantize_input(features, bits)[1]


class DeltaRSNNState(NamedTuple):
    """Per-slot step state of the ``delta`` backend: the core recurrent
    state plus the EdgeDRNN carries — ``x_prev`` the held input vector
    (skipped elements keep their last propagated value) and ``pre`` the
    cached L0 pre-activation reused when a slot propagates nothing."""

    rsnn: RSNNState
    x_prev: torch.Tensor  # (B, input_dim) held input
    pre: torch.Tensor  # (B, hidden_dim) cached x_hat @ l0_wx


def _tree_map(fn: Callable, tree):
    """``fn`` over every tensor of a (nested) NamedTuple/dict."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    return tree


def _leaves(tree) -> list[torch.Tensor]:
    """The tensors of a (nested) state NamedTuple, in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for field in tree for t in _leaves(field)]


def copy_state_(dst, src) -> None:
    """Copy every tensor of state ``src`` into the same field of ``dst``."""
    for a, b in zip(_leaves(dst), _leaves(src)):
        a.copy_(b)


def reset_slot_(state, i: int) -> None:
    """Zero slot ``i`` of ``state`` in place (fresh utterance boundary):
    row ``i`` of ``h0``/``h1`` along dim 1, of the LIF carries along dim 0,
    and of a ``DeltaRSNNState``'s held input and cached pre-activation — a
    fresh utterance must not inherit the previous occupant's.  Allocates
    nothing: every tensor keeps its storage."""
    if isinstance(state, DeltaRSNNState):
        reset_slot_(state.rsnn, i)
        state.x_prev[i].zero_()
        state.pre[i].zero_()
        return
    state.h0[:, i].zero_()
    state.h1[:, i].zero_()
    for s in (state.lif0, state.lif1):
        s.u[i].zero_()
        s.spike[i].zero_()


def reset_slot(state, i: int):
    """``reset_slot_`` on a copy: returns a new state and leaves the
    tensors of ``state`` as they were (the reference's functional form)."""
    out = _tree_map(torch.clone, state)
    reset_slot_(out, i)
    return out


def _check_packed(cfg: RSNNConfig, packed: PackedRSNN) -> None:
    """Shapes of the packed weights against the config, and every CSC row
    index and decoded N:M row inside its matrix (the gather kernels read
    them unchecked by the host; padding is index or offset 0)."""
    for name, (k, n) in cfg.layer_shapes.items():
        qt = packed.quant[name]
        if tuple(qt.packed.shape) != (k // 2, n) or qt.scale.numel() != n:
            raise ValueError(
                f"packed {name} is {tuple(qt.packed.shape)} with "
                f"{qt.scale.numel()} scales; the config needs ({k // 2}, "
                f"{n}) with {n}")
    for name, t in packed.sparse.items():
        if isinstance(t, SparseColumns):
            k = cfg.layer_shapes[name][0]
            if t.indices.numel() and not (
                    0 <= int(t.indices.min()) and int(t.indices.max()) < k):
                raise ValueError(f"CSC indices of {name} leave [0, {k})")
        elif isinstance(t, NMGroupPacked):
            k = cfg.layer_shapes[name][0]
            entries = t.packed.shape[0]
            if not 1 <= t.n <= t.m <= 16 or t.rows != k \
                    or entries != -(-k // t.m) * t.n:
                raise ValueError(
                    f"N:M tensor {name} has n={t.n} m={t.m} rows={t.rows} "
                    f"and {entries} entries a column; the layer needs "
                    f"1 <= n <= m <= 16, rows {k} and ceil({k} / m) * n "
                    f"entries")
            if entries and int(entry_rows(t).max()) >= k:
                raise ValueError(f"N:M rows of {name} leave [0, {k})")


def _to(tree, device: torch.device):
    """Move every tensor of a (nested) NamedTuple/dict to ``device``."""
    return _tree_map(lambda t: t.to(device), tree)


def _check_params(cfg: RSNNConfig, params: dict) -> None:
    """Names, shapes and dtypes of the float parameters against the config
    (the mirror of ``_check_packed``)."""
    h = (cfg.hidden_dim,)
    tensors, shapes = {}, dict(cfg.layer_shapes)
    for name in cfg.layer_shapes:
        tensors[name] = params.get(name)
    for i in (0, 1):
        for field in LIFParams._fields:
            key = f"lif{i}.{field}"
            tensors[key] = getattr(params.get(f"lif{i}"), field, None)
            shapes[key] = h
    for name, shape in shapes.items():
        t = tensors[name]
        if t is None:
            raise ValueError(f"float engine needs every parameter; missing: "
                             f"{name}")
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"float parameter {name} is {t.dtype} "
                             f"{tuple(t.shape)}; the config needs float32 "
                             f"{shape}")


class CompiledRSNN:
    """One RSNN ready for streaming inference on one device.

    Owns the weights (moved to ``device``): the raw float32 parameters at
    ``engine.precision="float"``, the packed int4 model at ``"int4"`` —
    given pre-packed (``packed=``), or packed here on ``device`` from float
    ``params`` by ``ccfg`` (its masks from ``cstate``, built when missing),
    as the reference's engine packs in process; the static input scale and
    the op table of its backend.  State threads through explicitly so
    callers control the frame/slot lifecycle; the
    ring steps (``step_ring``) update the state, the logit ring and the
    counter accumulator they are given in place.  ``capture_count`` counts
    the step graphs the slot loops over this engine captured (on the CPU,
    the eager steps that stand for them), the port's counterpart of the
    reference's ``compile_count``.
    """

    def __init__(self, cfg: RSNNConfig, params: dict | None,
                 engine: EngineConfig = EngineConfig(),
                 ccfg: CompressionConfig | None = None,
                 cstate: CompressionState | None = None, *,
                 packed: PackedRSNN | None = None,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.engine = engine
        if params is not None and packed is not None:
            raise ValueError("CompiledRSNN takes one payload: float params "
                             "or a packed int4 model (packed=), not both")
        if engine.precision == "int4":
            if packed is None:
                packed = self._pack(cfg, params, ccfg, cstate)
            dense, quant, sparse = self._load_int4(cfg, packed, engine)
        else:
            if params is None:
                raise ValueError("float precision needs the parameter dict "
                                 "(params), not a packed model")
            _check_params(cfg, params)
            self.packed = None
            params = _to(params, self.device)
            # beta/vth from the raw parameters on the engine's device, as
            # the golden model (core.rsnn.forward) computes them there
            self._lif = {}
            for i in (0, 1):
                beta, vth = lif_lib.inference_constants(params[f"lif{i}"],
                                                        cfg.hw_rounded_lif)
                self._lif[f"beta{i}"] = beta
                self._lif[f"vth{i}"] = vth
            dense = {n: params[n] for n in cfg.layer_shapes}
            quant, sparse = {}, {}
        # deployed FC pruning fraction, for the measured MMAC/s accounting
        self.fc_prune_frac = (ccfg.fc_prune_fraction
                              if engine.precision == "int4"
                              and ccfg is not None else 0.0)
        self._ctx = backends.BackendContext(
            cfg=cfg, precision=engine.precision,
            sparse_fc=engine.wants_sparse_fc, dense=dense, quant=quant,
            sparse=sparse, delta_threshold=engine.delta_threshold,
            spike_capacity=engine.spike_capacity)
        self.ops = backends.resolve(engine.backend, self._ctx)
        self._w = self._ctx.dense
        scale = engine.input_scale
        self._input_scale = (None if scale is None else torch.as_tensor(
            scale, dtype=torch.float32).to(self.device))
        self.capture_count = 0

    def _pack(self, cfg: RSNNConfig, params: dict | None,
              ccfg: CompressionConfig | None,
              cstate: CompressionState | None) -> PackedRSNN:
        """Pack float ``params`` on the engine's device: the masks of
        ``cstate`` (built from ``ccfg`` when missing), then int4 and the
        sparse layouts (``core.sparse.pack_model``)."""
        if params is None:
            raise ValueError("int4 precision needs params to pack (or a "
                             "pre-packed model via packed=)")
        if ccfg is None or ccfg.quant_spec is None:
            raise ValueError("int4 precision needs a CompressionConfig "
                             "with weight_bits set")
        _check_params(cfg, params)
        params = _to(params, self.device)
        cstate = (init_compression(params, ccfg) if cstate is None
                  else _to(cstate, self.device))
        return pack_model(params, cfg, ccfg, cstate)

    def _load_int4(self, cfg: RSNNConfig, packed: PackedRSNN,
                   engine: EngineConfig) -> tuple[dict, dict, dict]:
        """Check the packed model, move it to the device and return the
        backend's (dense, quant, sparse) bundles."""
        missing = set(cfg.layer_shapes) - set(packed.quant)
        if missing:
            raise ValueError(f"int4 engine needs every layer weight "
                             f"quantized; missing: {sorted(missing)}")
        if engine.wants_sparse_fc and "fc_w" not in packed.sparse:
            raise ValueError("sparse_fc needs a mask-pruned fc_w (a packed "
                             "sparse layout to serve)")
        _check_packed(cfg, packed)
        self.packed = _to(packed, self.device)
        # dense dequantized copies only where the backend consumes dense
        # weights: the recurrent cells always do; backends that declare
        # dense_stimulus (the plain ref path) need the feedforward ones too
        dense_needed = {"l0_wh", "l1_wh"}
        if backends.needs_dense_stimulus(engine.backend):
            dense_needed |= {"l0_wx", "l1_wx"}
        dense = {n: dequantize(self.packed.quant[n]) for n in dense_needed}
        self._lif = {k: v.to(torch.float32)
                     for k, v in self.packed.lif.items()}
        return dense, dict(self.packed.quant), dict(self.packed.sparse)

    def place_weights(self, device: torch.device | str) -> None:
        """Move every deployed tensor (the packed model, the op table's
        dense, quant and sparse bundles, the LIF constants and the input
        scale) to ``device``, make it the engine's device, and re-resolve
        the op table so that its steps read the placed copies."""
        device = resolve_device(device)
        put = functools.partial(_to, device=device)
        if self.packed is not None:
            self.packed = put(self.packed)
        self._ctx = dataclasses.replace(
            self._ctx, dense=put(self._ctx.dense), quant=put(self._ctx.quant),
            sparse=put(self._ctx.sparse))
        self.ops = backends.resolve(self.engine.backend, self._ctx)
        self._w = self._ctx.dense
        self._lif = put(self._lif)
        if self._input_scale is not None:
            self._input_scale = self._input_scale.to(device)
        self.device = device

    @classmethod
    def from_artifact(cls, path, engine: EngineConfig | None = None, *,
                      backend: str | None = None,
                      device: torch.device | str = "cuda") -> "CompiledRSNN":
        """Build an engine from an on-disk deployment artifact
        (``core/artifact.py``), int4 or float.

        ``engine=None`` derives the execution path from the manifest: the
        artifact's precision, its preferred backend (overridable via
        ``backend=``), its zero-skip FC preference and its stored static
        input scale.  An explicit ``engine`` is used verbatim,
        ``delta_threshold`` and ``spike_capacity`` included, and must
        match the artifact's precision.  The manifest's compression config
        gives ``fc_prune_frac``.
        """
        from repro_torch.core import artifact as artifact_lib

        device = resolve_device(device)
        art = artifact_lib.load_artifact(path)
        if engine is None:
            engine = EngineConfig(backend=backend or art.backend or "jnp",
                                  precision=art.precision,
                                  sparse_fc=art.sparse_fc,
                                  input_scale=art.input_scale)
        elif engine.precision != art.precision:
            raise ValueError(
                f"engine precision {engine.precision!r} does not match the "
                f"artifact's {art.precision!r} payload")
        if art.precision == "int4":
            return cls(art.cfg, None, engine, art.ccfg, packed=art.packed,
                       device=device)
        return cls(art.cfg, art.params, engine, device=device)

    # ------------------------------------------------------------ frontend

    def init_state(self, batch: int):
        """Zero state for ``batch`` slots; a ``DeltaRSNNState`` with zero
        carries when the backend gates its input (so frame 1 of every
        stream propagates all its nonzero elements)."""
        state = rsnn.init_state(self.cfg, batch, device=self.device)
        if self.ops.delta_gate is None:
            return state

        def z(n):
            return torch.zeros((batch, n), dtype=torch.float32,
                               device=self.device)

        return DeltaRSNNState(rsnn=state, x_prev=z(self.cfg.input_dim),
                              pre=z(self.cfg.hidden_dim))

    def quantize_features(self, x) -> torch.Tensor:
        """8-bit fixed-point input quantization with the static scale.

        ``input_scale=None`` means the features are already integer-valued
        (pre-quantized upstream); that contract is checked here.
        """
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        if self._input_scale is None and bool((x != torch.round(x)).any()):
            raise ValueError(
                "input_scale=None requires integer-valued features; pass "
                "input_scale=calibrate_input_scale(features)")
        return self._quantize(x)

    def _quantize(self, x: torch.Tensor) -> torch.Tensor:
        """``quantize_features`` without the integer check (the loop checks
        at submit time)."""
        if self._input_scale is None:
            return x
        return spike_ops.quantize_input(x, self.cfg.input_bits,
                                        self._input_scale)[0]

    # ------------------------------------------------------- layer dispatch

    def _frame_step(self, state, x_t: torch.Tensor):
        """One quantized frame x_t (B, input_dim) -> (state, logits, aux).
        A ``megastep`` table runs the frame as one launch.  With a
        ``delta_gate`` the gate runs first: it propagates only the
        elements with ``|x_t - x_prev| > threshold``, holds the rest, and
        reuses the cached L0 pre-activation of a slot with no delta; the
        held ``x_hat`` also feeds the bit counters."""
        if self.ops.megastep is not None:
            # the whole frame in one mega-step launch: chunk-native, one
            # frame is its F = 1 case
            state, logits, aux = self.ops.megastep(state, x_t[None],
                                                   self._lif)
            return state, logits[0], {k: v[0] for k, v in aux.items()}
        if self.ops.delta_gate is None:
            return self._compose_step(state, x_t)
        x_hat, pre, mask = self.ops.delta_gate(x_t, state.x_prev, state.pre)
        core, logits, aux = self._compose_step(state.rsnn, x_hat, ff0=pre)
        prop = mask.sum(dim=1)
        aux = dict(aux, delta_propagated=prop,
                   delta_skipped=x_t.shape[1] - prop)
        return DeltaRSNNState(rsnn=core, x_prev=x_hat, pre=pre), logits, aux

    def _compose_step(self, state: RSNNState, x_t: torch.Tensor,
                      ff0: torch.Tensor | None = None):
        """Both cells, the readout, and the counters of one frame, composed
        from the op table — every kernel choice goes through ``self.ops``.
        ``ff0`` replaces the L0 feedforward stimulus (the delta route's
        gated pre-activation)."""
        cell, ff, fc = self.ops.rsnn_cell, self.ops.ff_matmul, self.ops.fc
        w, lif = self._w, self._lif
        ts, b, h = state.h0.shape[0], x_t.shape[0], self.cfg.hidden_dim

        # L0: feedforward stimulus once per frame, a broadcast view over TS
        if ff0 is None:
            ff0 = ff(x_t, "l0_wx")  # (B, H)
        stim0 = ff0.unsqueeze(0).expand(ts, b, h)
        s0, u0 = cell(stim0, state.h0, w["l0_wh"], state.lif0.u,
                      state.lif0.spike, lif["beta0"], lif["vth0"])
        lif0 = LIFState(u=u0, spike=s0[-1])

        # L1: per-ts feedforward from L0 spikes + recurrent
        stim1 = ff(s0.reshape(ts * b, h), "l1_wx").reshape(ts, b, h)
        s1, u1 = cell(stim1, state.h1, w["l1_wh"], state.lif1.u,
                      state.lif1.spike, lif["beta1"], lif["vth1"])
        lif1 = LIFState(u=u1, spike=s1[-1])

        logits = fc(s1)
        aux = _frame_counters(x_t, s0, s1, self.cfg.input_bits)
        return RSNNState(h0=s0, h1=s1, lif0=lif0, lif1=lif1), logits, aux

    def _chunk_step(self, state, x_chunk: torch.Tensor):
        """Advance every slot by a chunk of F quantized frames: ``x_chunk``
        (F, B, input_dim) -> (state, logits (F, B, fc_dim), aux with a
        leading frame axis).  A ``megastep`` table runs the whole chunk as
        one launch, the state held on chip across it; a per-op table steps
        ``_frame_step`` frame by frame.  Frames are sequential either way,
        so a chunk equals F single-frame steps bit for bit."""
        if self.ops.megastep is not None:
            return self.ops.megastep(state, x_chunk, self._lif)
        logits, aux = [], []
        for x_t in x_chunk:
            state, lg, ax = self._frame_step(state, x_t)
            logits.append(lg)
            aux.append(ax)
        return state, torch.stack(logits), {
            k: torch.stack([a[k] for a in aux]) for k in aux[0]}

    def _masked_chunk_step(self, state, x_chunk: torch.Tensor,
                           active: torch.Tensor):
        """Chunked ``step_masked``: ``active`` is the (F, slots) fill mask
        of the sub-steps.  A False entry is idle padding (a ragged stream
        tail or a mid-chunk completion): the slot advances on a zero frame,
        as an idle slot does frame by frame, and is masked out of the
        packed counters."""
        state, logits, aux = self._chunk_step(state, x_chunk)
        return state, logits, pack_chunk_aux(aux, active)

    # --------------------------------------------------- v2 ring steps

    def _ring_write(self, ring: torch.Tensor, ring_idx: torch.Tensor,
                    logits: torch.Tensor) -> torch.Tensor:
        """Write each slot's logits row into its ring row ``ring_idx``, in
        place."""
        rows = torch.arange(logits.shape[0], device=ring.device)
        ring.index_put_((rows, ring_idx.long()), logits)
        return ring

    def _ring_write_chunk(self, ring: torch.Tensor, ring_idx: torch.Tensor,
                          logits: torch.Tensor) -> torch.Tensor:
        """Write an (F, B, fc) chunk of logit rows into the ring rows
        ``ring_idx`` (F, B), in place.  Idle sub-steps carry the index
        ``ring_frames``: the ring holds one spare row there
        (``StreamLoop._init_ring``), which takes those writes, so the idle
        tail after a mid-chunk completion never touches the completed
        stream's rows (the reference drops them with ``mode="drop"``,
        which ``index_put_`` has no counterpart of)."""
        f, b, fc = logits.shape
        rows = torch.arange(b, device=ring.device).repeat(f)
        ring.index_put_((rows, ring_idx.reshape(-1).long()),
                        logits.reshape(f * b, fc))
        return ring

    def _ring_frame_step(self, state, x_t: torch.Tensor,
                         active: torch.Tensor, ring: torch.Tensor,
                         ring_idx: torch.Tensor, aux_acc: torch.Tensor):
        new, logits, aux = self._frame_step(state, x_t)
        copy_state_(state, new)
        self._ring_write(ring, ring_idx, logits)
        aux_acc.add_(pack_step_aux(aux, active))
        return state, ring, aux_acc

    def _ring_frame_step_quiet(self, state, x_t: torch.Tensor,
                               ring: torch.Tensor, ring_idx: torch.Tensor):
        new, logits, _ = self._frame_step(state, x_t)
        copy_state_(state, new)
        self._ring_write(ring, ring_idx, logits)
        return state, ring

    def _ring_chunk_step(self, state, x_chunk: torch.Tensor,
                         active: torch.Tensor, ring: torch.Tensor,
                         ring_idx: torch.Tensor, aux_acc: torch.Tensor):
        new, logits, aux = self._chunk_step(state, x_chunk)
        copy_state_(state, new)
        self._ring_write_chunk(ring, ring_idx, logits)
        aux_acc.add_(pack_chunk_aux(aux, active))
        return state, ring, aux_acc

    def _ring_chunk_step_quiet(self, state, x_chunk: torch.Tensor,
                               ring: torch.Tensor, ring_idx: torch.Tensor):
        new, logits, _ = self._chunk_step(state, x_chunk)
        copy_state_(state, new)
        self._ring_write_chunk(ring, ring_idx, logits)
        return state, ring

    # ------------------------------------------------------------ execution

    def step(self, state, x_q: torch.Tensor):
        """Advance every slot by one quantized frame. x_q: (B, input_dim).
        Returns (state, logits (B, fc_dim), per-slot counters)."""
        return self._frame_step(state, x_q)

    def step_masked(self, state, x_q: torch.Tensor, active: torch.Tensor):
        """``step`` with idle-slot masking of the counters: returns (state,
        logits, packed counter vector) where the vector is already masked
        to active slots and reduced (``pack_step_aux``)."""
        state, logits, aux = self._frame_step(state, x_q)
        return state, logits, pack_step_aux(aux, active)

    def step_ring(self, state, x_raw, ctrl: torch.Tensor, ring: torch.Tensor,
                  aux_acc: torch.Tensor):
        """Contract-v2 step over raw frames ``x_raw`` (B, input_dim): input
        quantization, the frame step, the logit write into ``ring`` at the
        per-slot row ``ctrl[1]`` and the ``ctrl[0]``-masked packed-counter
        add into ``aux_acc``.  ``ctrl`` is the (2, slots) int32 control
        word.  The state, ``ring`` and ``aux_acc`` are updated in place and
        returned: (state, ring, aux_acc).  Nothing crosses to the host."""
        x = torch.as_tensor(x_raw, dtype=torch.float32).to(self.device)
        return self._ring_frame_step(state, self._quantize(x), ctrl[0], ring,
                                     ctrl[1], aux_acc)

    def step_ring_quiet(self, state, x_raw, ctrl: torch.Tensor,
                        ring: torch.Tensor):
        """``step_ring`` without the counter accumulator (the step's
        counters are computed and dropped).  Returns (state, ring)."""
        x = torch.as_tensor(x_raw, dtype=torch.float32).to(self.device)
        return self._ring_frame_step_quiet(state, self._quantize(x), ring,
                                           ctrl[1])

    def _run_scan(self, state, xq: torch.Tensor):
        """Step every frame of ``xq`` (B, T, input_dim) in order -> (state,
        logits (B, T, fc_dim), aux stacked per frame)."""
        logits, aux = [], []
        for x_t in xq.transpose(0, 1):
            state, lg, ax = self._frame_step(state, x_t)
            logits.append(lg)
            aux.append(ax)
        return state, torch.stack(logits, dim=1), {
            k: torch.stack([a[k] for a in aux]) for k in aux[0]}

    def run(self, x, state=None):
        """Batch-run a chunk of raw frames ``x`` (B, T_chunk, input_dim),
        carrying ``state`` across calls.  Returns (logits (B, T_chunk,
        fc_dim), state, aux); the aux counters are stacked per frame and
        summed over the slots."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        if state is None:
            state = self.init_state(x.shape[0])
        state, logits, aux = self._run_scan(state, self.quantize_features(x))
        return logits, state, {k: v.sum(dim=-1) for k, v in aux.items()}


def _frame_counters(x_t: torch.Tensor, s0: torch.Tensor, s1: torch.Tensor,
                    input_bits: int) -> dict:
    """Per-slot zero-skip counters for one frame."""
    one_bits = spike_ops.bitplanes(x_t, input_bits).sum(dim=(1, 2))  # (B,)
    zero = torch.zeros_like(one_bits, dtype=torch.float32)
    return {
        "spikes_l0": s0.sum(dim=2),  # (TS, B)
        "spikes_l1": s1.sum(dim=2),  # (TS, B)
        "union_l1": s1.amax(dim=0).sum(dim=1),  # (B,)
        "input_one_bits": one_bits.to(torch.float32),  # (B,)
        # delta-gating counters: zero unless the delta route overwrites
        # them (zero totals read back as density 1.0, "not measured")
        "delta_propagated": zero,  # (B,)
        "delta_skipped": zero,  # (B,)
    }


def pack_step_aux(aux: dict, active: torch.Tensor) -> torch.Tensor:
    """Mask the per-slot counters of one step by ``active`` and reduce over
    slots, packed into one flat vector: ``[spikes_l0 (TS,), spikes_l1
    (TS,), union_l1, input_one_bits, delta_propagated, delta_skipped]`` —
    one host transfer per step instead of one per counter key."""
    act = active.to(torch.float32)
    return torch.cat([
        (aux["spikes_l0"] * act).sum(dim=-1),
        (aux["spikes_l1"] * act).sum(dim=-1),
        (aux["union_l1"] * act).sum(dim=-1, keepdim=True),
        (aux["input_one_bits"] * act).sum(dim=-1, keepdim=True),
        (aux["delta_propagated"] * act).sum(dim=-1, keepdim=True),
        (aux["delta_skipped"] * act).sum(dim=-1, keepdim=True),
    ])


def pack_chunk_aux(aux: dict, active: torch.Tensor) -> torch.Tensor:
    """``pack_step_aux`` of every sub-step of a chunk (``aux`` with a
    leading frame axis) under its row of the (F, slots) fill mask
    ``active``, summed over the sub-steps."""
    return torch.stack([
        pack_step_aux({k: v[f] for k, v in aux.items()}, active[f])
        for f in range(active.shape[0])]).sum(dim=0)


def unpack_step_aux(vec, num_ts: int) -> dict:
    """Host-side inverse of ``pack_step_aux`` -> the dict
    ``complexity.SparsityCounters.update`` consumes."""
    v = (vec.detach().cpu().numpy() if isinstance(vec, torch.Tensor)
         else np.asarray(vec))
    return {"spikes_l0": v[:num_ts], "spikes_l1": v[num_ts:2 * num_ts],
            "union_l1": v[2 * num_ts], "input_one_bits": v[2 * num_ts + 1],
            "delta_propagated": v[2 * num_ts + 2],
            "delta_skipped": v[2 * num_ts + 3]}


# ---------------------------------------------------------------------------
# Slot-based continuous batching over audio streams
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamRequest:
    """One utterance: its frames in, its per-frame logits out.

    In the pipelined contract a stream's logits reach the host as blocks
    in ``pending``, one per completion or watermark flush: ``(block, fill,
    fence)``, where ``block`` holds the stream's ``fill`` ring rows, copied
    at harvest time (a pinned host tensor filled by a copy queued on the
    card's stream, behind the step), and ``fence`` the event after which
    the copy has landed (``None`` on the CPU, where the copy is made at
    once).  They move into ``logits`` when the pipeline retires the
    completing step, or on the first ``stacked_logits`` call: as rows of
    the block itself, with no host copy, so the request holds its block
    (pinned memory returns to PyTorch's host cache when the rows go).

    Lifecycle timestamps (``StreamLoop.clock``, monotonic seconds):
    ``t_submit`` at enqueue, ``t_start`` when the stream takes a slot,
    ``t_done`` when its last frame is scheduled and ``t_harvest`` when its
    logits are on the host: the same moment in the synchronous contract,
    the retirement of the completing step in the pipelined one.
    """

    sid: int
    frames: np.ndarray  # (T, input_dim) raw features
    fc_dim: int = 0  # logit width, stamped by StreamLoop.submit
    logits: list = dataclasses.field(default_factory=list)
    done: bool = False
    pending: list = dataclasses.field(default_factory=list, repr=False)
    t_submit: float | None = None
    t_start: float | None = None
    t_done: float | None = None
    t_harvest: float | None = None

    def _materialize(self) -> int:
        """Move the pending logit blocks into ``logits`` rows, each after
        its fence; returns the number of device->host transfers they
        were."""
        n = len(self.pending)
        for block, fill, fence in self.pending:
            if fence is not None:
                fence.synchronize()
            self.logits.extend(block.numpy()[:fill])
        self.pending.clear()
        return n

    def stacked_logits(self) -> np.ndarray:
        self._materialize()
        if not self.logits:
            return np.zeros((0, self.fc_dim), np.float32)
        return np.stack(self.logits)


def host_copy(rows: torch.Tensor) -> torch.Tensor:
    """``rows`` copied to the host: into a pinned block by a copy queued
    on the card's stream (it lands behind the work queued before it), or
    cloned on the CPU."""
    if not rows.is_cuda:
        return rows.clone()
    block = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
    block.copy_(rows, non_blocking=True)
    return block


class _InflightStep:
    """One dispatched step not yet retired: its fence (a ``torch.cuda.Event``
    recorded after the step and its harvest copies; ``None`` on the CPU)
    and the requests whose completion rode on it."""

    __slots__ = ("fence", "completed")

    def __init__(self, fence, completed):
        self.fence = fence
        self.completed = completed  # list[StreamRequest]


class _StepGraph:
    """A loop's step captured as a CUDA graph: ``__call__`` replays it and
    credits the kernel launches the capture recorded to the wrappers'
    counters (a replay runs no Python); returns the step's outputs, the
    graph's static output tensors.  It holds the captured step ``fn``: a
    tensor that ``fn`` closes over is read by every replay, and must not
    return to the allocator."""

    def __init__(self, graph, fn: Callable, outputs,
                 launches: dict[str, int]):
        self.graph = graph
        self.fn = fn
        self.outputs = outputs
        self.launches = {n: c for n, c in launches.items() if c}

    def __call__(self):
        self.graph.replay()
        kernel_ops.add_launch_counts(self.launches)
        return self.outputs


class StreamLoop(SlotScheduler):
    """Continuous batching of audio streams over recurrent-state slots.

    N submitted utterances share a fixed batch of ``batch_slots`` rows.
    Each ``step_once`` advances every active slot by one frame; a slot
    whose utterance ends is state-reset and refilled from the queue
    mid-batch.  Idle slots carry zero frames and are excluded from the
    sparsity counters.

    ``pipeline_depth`` selects the contract (module docstring): ``0`` is
    the synchronous v1 loop (the logits, and the packed counter vector
    when a sink is attached, cross to the host every step); ``>= 1`` the
    pipelined v2 loop, with at most ``pipeline_depth`` steps in flight,
    the logits kept in a device ring of ``ring_frames`` rows a slot and
    the counters accumulated on the device.  ``chunk_frames=C`` advances
    every active slot by up to C frames in one dispatch: slot i serves
    ``min(C, remaining frames)`` and idles for the rest, masked out of the
    ring writes and the counters; completions, refills and the ring
    watermark are decided at the chunk boundary, so per-stream logits and
    counters equal ``chunk_frames=1``'s bit for bit.  In the pipelined
    contract ``ring_frames`` must be a multiple of C, so that a live slot
    never idles mid-chunk on ring capacity.  Scheduling is the reference's
    in every contract; only when data crosses to the host changes.

    The loop allocates its state, ring, counter accumulator and step
    inputs once and only writes into them (``reset_slot_``, ``copy_``,
    ``index_put_``, ``add_``).  Frames and the control word reach the card
    through ``pipeline_depth + 1`` pinned host buffers in rotation, copied
    asynchronously.  With ``aot_warmup=True`` on a CUDA engine the
    constructor warms the step up on a side stream over scratch copies of
    those buffers, then captures it as one CUDA graph for the loop's
    signature ``_key``, (contract, slots, chunk, ring_frames,
    track_sparsity); every step replays it.  A graph binds its buffers'
    addresses, so it belongs to its loop and is not shared with other
    loops.  On the CPU the eager step stands in for the graph, and counts
    as its capture.  ``aot_warmup=False`` dispatches the eager step.  A
    failed capture or replay raises; the loop never carries on eagerly.

    The data path goes through hooks, so that ``serving/sharded.py``'s
    subclass overrides it and nothing of the scheduling:
    ``_build_data_path`` (state, ring, accumulator, inputs, step),
    ``_dispatch_step``, ``_dispatch_ring_step``, ``_dispatch_step_chunk``
    and ``_dispatch_ring_chunk`` (one each for v1 and v2, by frame and by
    chunk), ``_reset_slot``, ``_harvest``, ``_aux_total`` and
    ``_zero_aux``.

    ``host_syncs`` counts the device->host transfers the loop makes,
    ``dispatches`` its step dispatches (one a chunk) and ``frames_served``
    the slot-frames advanced.  ``track_sparsity=False`` detaches the
    counter sink: no counter fetch and no accumulator.
    """

    def __init__(self, engine: CompiledRSNN, batch_slots: int = 4,
                 pipeline_depth: int = 2, ring_frames: int = 256,
                 track_sparsity: bool = True, chunk_frames: int = 1,
                 aot_warmup: bool = True):
        super().__init__(batch_slots)
        if pipeline_depth < 0:
            raise ValueError(f"pipeline_depth must be >= 0, "
                             f"got {pipeline_depth}")
        if ring_frames < 1:
            raise ValueError(f"ring_frames must be >= 1, got {ring_frames}")
        if chunk_frames < 1:
            raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
        if (chunk_frames > 1 and pipeline_depth >= 1
                and ring_frames % chunk_frames != 0):
            # a live slot's ring fill advances in whole chunks; any other
            # ring would make a live slot idle mid-chunk on ring capacity
            # and advance its state through frames it never received
            raise ValueError(
                f"ring_frames ({ring_frames}) must be a multiple of "
                f"chunk_frames ({chunk_frames}) in the pipelined contract")
        self.engine = engine
        self.pipeline_depth = pipeline_depth
        self.ring_frames = ring_frames
        self.track_sparsity = track_sparsity
        self.chunk_frames = chunk_frames
        self.aot_warmup = aot_warmup
        self.clock = time.monotonic  # swappable for deterministic tests
        self._flushed = [0] * batch_slots  # frames already harvested, per slot
        self._inflight: collections.deque[_InflightStep] = collections.deque()
        self._fence = None  # the fence of the step being dispatched
        self._build_data_path()
        self.reset_metrics()

    def _build_data_path(self) -> None:
        """The loop's device side, allocated once: the slot state, the v2
        ring and counter accumulator, the step inputs and the step."""
        eng = self.engine
        self.state = eng.init_state(self.slots)
        v2 = self.pipeline_depth >= 1
        self._ring = self._init_ring(self.slots, eng.device) if v2 else None
        self._aux_acc = (self._zero_aux_acc(eng.device)
                         if v2 and self.track_sparsity else None)
        self._init_inputs()
        self._key, fn = self._step_fn()
        self._entry = self._bind_step(eng, fn, (
            self._x_in, self._ctrl_in, self.state, self._ring,
            self._aux_acc))

    def _bind_step(self, eng: CompiledRSNN, fn: Callable, args: tuple
                   ) -> Callable:
        """The step ``fn`` bound to its buffers ``args``: they never move,
        so they are bound once (and the loop is not: no reference cycle
        through the entry).  With ``aot_warmup`` the step is captured as a
        CUDA graph over them on a CUDA engine ``eng`` (on the CPU the eager
        step stands in), and the loop's engine counts the capture."""
        entry = functools.partial(fn, *args)
        if self.aot_warmup:
            if eng.device.type == "cuda":
                entry = self._capture(fn, args, eng.device)
            self.engine.capture_count += 1
        return entry

    def _init_ring(self, slots: int, device: torch.device) -> torch.Tensor:
        """A device logit ring, ``(slots, ring_frames + 1, fc_dim)``: the
        spare last row of each slot takes the idle sub-steps' writes of a
        chunk (``CompiledRSNN._ring_write_chunk``).  ``ring`` is the view
        without it."""
        return torch.zeros((slots, self.ring_frames + 1,
                            self.engine.cfg.fc_dim), dtype=torch.float32,
                           device=device)

    def _zero_aux_acc(self, device: torch.device) -> torch.Tensor:
        """A zeroed packed-counter accumulator on ``device``."""
        return torch.zeros((2 * self.engine.cfg.num_ts + 4,),
                           dtype=torch.float32, device=device)

    @property
    def ring(self) -> torch.Tensor | None:
        """The logit ring, ``(slots, ring_frames, fc_dim)`` (v2 only)."""
        return None if self._ring is None else self._ring[:, :self.ring_frames]

    # -------------------------------------------------- step inputs / graphs

    def _init_inputs(self) -> None:
        """The step's static inputs on the device, ([C,] slots, input_dim)
        frames and the (2, [C,] slots) int32 control word (row 0 the fill
        mask, row 1 the ring row), and the host buffers they are staged
        in, allocated once (a fresh host buffer a step costs its page
        faults): on a CUDA engine ``pipeline_depth + 1`` pinned pairs,
        each with the event after which its last upload has landed; on
        the CPU the inputs themselves."""
        b, c = self.slots, self.chunk_frames
        lead = () if c == 1 else (c,)
        x_shape = (*lead, b, self.engine.cfg.input_dim)
        ctrl_shape = (2, *lead, b)
        dev = self.engine.device
        if dev.type == "cuda":  # pin_memory needs CUDA
            self._x_in = torch.zeros(x_shape, dtype=torch.float32,
                                     device=dev)
            self._ctrl_in = torch.zeros(ctrl_shape, dtype=torch.int32,
                                        device=dev)
            self._staging = [
                (torch.zeros(x_shape, dtype=torch.float32, pin_memory=True),
                 torch.zeros(ctrl_shape, dtype=torch.int32, pin_memory=True),
                 torch.cuda.Event())
                for _ in range(self.pipeline_depth + 1)]
        else:
            self._x_in = torch.zeros(x_shape, dtype=torch.float32)
            self._ctrl_in = torch.zeros(ctrl_shape, dtype=torch.int32)
            self._staging = [(self._x_in, self._ctrl_in, None)]
        self._stage_next = 0

    def _step_fn(self) -> tuple[tuple, Callable]:
        """(key, fn) of the step this loop dispatches: ``fn(x, ctrl, state,
        ring, aux_acc)`` quantizes the raw frames ``x`` and runs the
        contract's step over those buffers, in place (``_contract_fn``);
        ``ctrl`` is the (2, [C,] slots) word [fill mask; ring row]."""
        eng = self.engine

        def frames(x, ctrl):
            return eng._quantize(x), ctrl[0], ctrl[1]

        return self._contract_fn(eng, self.slots, frames)

    def _contract_fn(self, eng: CompiledRSNN, slots: int, frames: Callable
                     ) -> tuple[tuple, Callable]:
        """(key, fn) of the contract's step over ``slots`` slots of
        ``eng``: ``fn(src, ctrl, state, ring, aux_acc)`` takes the step's
        quantized frames, fill mask and ring rows from ``frames(src,
        ctrl)`` and updates its buffers in place; it returns v1's (logits,
        packed counter vector) and nothing in v2.  The key is (contract,
        slots, chunk, ring_frames, track_sparsity)."""
        c = self.chunk_frames
        if self.pipeline_depth == 0:
            step = eng.step_masked if c == 1 else eng._masked_chunk_step
            contract = "v1" if c == 1 else "v1-chunk"

            def fn(src, ctrl, state, ring, aux_acc):
                x, active, _ = frames(src, ctrl)
                new, logits, vec = step(state, x, active)
                copy_state_(state, new)
                return logits, vec
        elif self.track_sparsity:
            step = eng._ring_frame_step if c == 1 else eng._ring_chunk_step
            contract = "v2" if c == 1 else "v2-chunk"

            def fn(src, ctrl, state, ring, aux_acc):
                x, active, ring_idx = frames(src, ctrl)
                step(state, x, active, ring, ring_idx, aux_acc)
        else:
            step = (eng._ring_frame_step_quiet if c == 1
                    else eng._ring_chunk_step_quiet)
            contract = "v2-quiet" if c == 1 else "v2-chunk-quiet"

            def fn(src, ctrl, state, ring, aux_acc):
                x, _, ring_idx = frames(src, ctrl)
                step(state, x, ring, ring_idx)
        key = (contract, slots, c, self.ring_frames, self.track_sparsity)
        return key, fn

    def _capture(self, fn: Callable, args: tuple, dev: torch.device
                 ) -> _StepGraph:
        """Warm the step up on a side stream over scratch copies of the
        state, ring and accumulator (the plan and occupancy caches fill,
        the live buffers do not move), then capture it over the live
        buffers.  The kernel counters are restored afterwards, so neither
        the warm-up nor the capture counts as launches; the capture's own
        launches are kept and credited at every replay.  The capture is
        begun and ended by hand: ``torch.cuda.graph`` would also empty
        PyTorch's caches, the pinned host blocks of earlier harvests
        among them, and every later harvest would pin new memory."""
        saved = kernel_ops.launch_counts()
        scratch = (*args[:2], *(_tree_map(torch.clone, t) for t in args[2:]))
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.stream(side):
                    for _ in range(WARMUP_STEPS):
                        fn(*scratch)
                torch.cuda.synchronize(dev)
                kernel_ops.set_launch_counts(dict.fromkeys(saved, 0))
                with torch.cuda.stream(side):
                    graph.capture_begin()
                    try:
                        outputs = fn(*args)
                    finally:
                        graph.capture_end()
                launches = kernel_ops.launch_counts()
            finally:
                kernel_ops.set_launch_counts(saved)
        return _StepGraph(graph, fn, outputs, launches)

    def _stage(self) -> tuple[np.ndarray, np.ndarray]:
        """The host buffers of the next step's frames and control word,
        zeroed: the next pinned pair of the rotation once the upload that
        last read it has landed (CUDA), or the step's own inputs (CPU)."""
        hx, hc, landed = self._staging[self._stage_next]
        if landed is not None:
            landed.synchronize()
        x, ctrl = hx.numpy(), hc.numpy()
        x.fill(0)
        ctrl.fill(0)
        return x, ctrl

    def _dispatch(self):
        """Dispatch the step over the staged inputs (replay its graph, or
        run it eagerly).  On a CUDA engine the pinned pair is uploaded
        first, asynchronously, and the step's fence is created, which the
        caller records after its harvests.  Returns the step's outputs."""
        hx, hc, landed = self._staging[self._stage_next]
        self._stage_next = (self._stage_next + 1) % len(self._staging)
        if landed is not None:
            self._x_in.copy_(hx, non_blocking=True)
            self._ctrl_in.copy_(hc, non_blocking=True)
            landed.record()
            if self.pipeline_depth >= 1:
                self._fence = torch.cuda.Event()
        return self._entry()

    def _push_inflight(self, completed: list[StreamRequest]) -> None:
        """Fence the step just dispatched (and its harvest copies) and
        retire the oldest steps down to ``pipeline_depth - 1`` in flight."""
        fence, self._fence = self._fence, None
        if fence is not None:
            fence.record()
        self._inflight.append(_InflightStep(fence, completed))
        while len(self._inflight) > max(self.pipeline_depth - 1, 0):
            self._retire()

    # ------------------------------------------------------------- frontend

    def submit(self, frames: np.ndarray) -> int:
        return self._enqueue(self._validate_frames(frames))

    def _validate_frames(self, frames) -> np.ndarray:
        frames = np.asarray(frames)
        d = self.engine.cfg.input_dim
        if frames.ndim != 2 or frames.shape[-1] != d:
            raise ValueError(
                f"frames must have shape (T, input_dim={d}); "
                f"got {frames.shape}")
        if (self.engine._input_scale is None
                and frames.size and np.any(frames != np.round(frames))):
            # the step quantizes without the integer check (a host sync),
            # so the contract is checked here, once an utterance
            raise ValueError(
                "input_scale=None requires integer-valued features; "
                "pass input_scale=calibrate_input_scale(features)")
        return frames

    def _enqueue(self, frames: np.ndarray) -> int:
        sid = self._new_sid()
        req = StreamRequest(sid, frames, fc_dim=self.engine.cfg.fc_dim)
        req.t_submit = self.clock()
        if len(req.frames) == 0:  # empty utterance: nothing to stream
            req.done = True
            req.t_start = req.t_done = req.t_harvest = req.t_submit
            self.finished.append(req)
        else:
            self.queue.append(req)
        return sid

    def _on_slot_filled(self, i: int, req: StreamRequest) -> None:
        """Fresh utterance boundary: zero the slot's recurrent state and
        harvest cursor.  The previous occupant's ring rows were copied out
        at its completion, so the new stream may overwrite them."""
        req.t_start = self.clock()
        self._flushed[i] = 0
        self._reset_slot(i)

    def _reset_slot(self, i: int) -> None:
        """Zero slot ``i``'s recurrent state in place."""
        reset_slot_(self.state, i)

    def _finish_slot(self, i: int) -> StreamRequest:
        req = super()._finish_slot(i)
        req.t_done = self.clock()
        if self.pipeline_depth == 0:
            # synchronous contract: the logits were fetched this step
            req.t_harvest = req.t_done
        return req

    def _harvest(self, r: StreamRequest, i: int, fill: int) -> None:
        """Queue slot ``i``'s first ``fill`` ring rows for the host.  The
        rows are copied now, behind the step on the card's stream: the slot
        (or the next stream in it) overwrites them before the step
        retires, so a view would not do."""
        r.pending.append((host_copy(self._ring[i, :fill]), fill, self._fence))

    # ------------------------------------------------------------ step path

    def _gather_host_frames(self, x: np.ndarray) -> None:
        """Host-side frame assembly into the zeroed (slots, input_dim)
        ``x``: idle slots carry zero frames (the counter masking keys off
        the active mask, not this zeroing)."""
        for i, r in enumerate(self.slot_req):
            if r is not None:
                x[i] = r.frames[self.slot_pos[i]]

    def _dispatch_step(self, active: np.ndarray):
        """v1: advance every slot one frame.  Returns (logits (slots,
        fc_dim) np, packed masked counter vector)."""
        x, ctrl = self._stage()
        self._gather_host_frames(x)
        ctrl[0] = active
        logits, vec = self._dispatch()
        return logits.cpu().numpy(), vec

    def _dispatch_ring_step(self, ctrl: np.ndarray) -> None:
        """v2: dispatch one pipelined step over the (2, slots) control
        word [active mask; ring row]; nothing crosses to the host."""
        x, word = self._stage()
        self._gather_host_frames(x)
        word[:] = ctrl
        self._dispatch()

    def step_once(self) -> bool:
        """One engine step over all slots; returns False when fully drained
        (empty queue, empty slots and, pipelined, no step in flight)."""
        self._refill()
        active = self.active_mask()
        if not active.any():
            if self._inflight:  # shutdown drain: retire without dispatching
                self._retire()
                return True
            return False
        if self.pipeline_depth == 0:
            if self.chunk_frames == 1:
                return self._step_once_sync(active)
            return self._step_once_sync_chunk()
        if self.chunk_frames > 1:
            return self._step_once_chunk()

        ctrl = np.zeros((2, self.slots), np.int32)  # [active; ring row]
        ctrl[0] = active
        ctrl[1] = [self.slot_pos[i] - self._flushed[i]
                   if self.slot_req[i] is not None else 0
                   for i in range(self.slots)]
        self._dispatch_ring_step(ctrl)
        self.steps += 1
        self.dispatches += 1
        self.frames_served += int(active.sum())
        if self.counters is not None:
            self._frames_acc += float(active.sum())
        self._push_inflight(self._advance_slots())
        return True

    def _step_once_sync(self, active: np.ndarray) -> bool:
        """v1: fetch the logits (and the counters, when a sink is
        attached) to the host every step."""
        logits_np, aux_vec = self._dispatch_step(active)
        self.host_syncs += 1  # per-frame logit fetch
        self.steps += 1
        self.dispatches += 1
        self.frames_served += int(active.sum())
        if self.counters is not None:
            self.counters.update(
                unpack_step_aux(aux_vec, self.engine.cfg.num_ts),
                active_frames=float(active.sum()))
            self.host_syncs += 1  # per-frame counter fetch
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            r.logits.append(logits_np[i])
            self.slot_pos[i] += 1
            if self.slot_pos[i] == len(r.frames):
                self._finish_slot(i)
                self._reset_slot(i)
        return True

    def _advance_slots(self) -> list[StreamRequest]:
        """Dispatch-time bookkeeping of v2: advance the cursors, harvest
        completed and watermark-full slots, reset and free finished ones.
        Completion depends only on host-side frame counts, so this runs
        while the step is in flight; the schedule is v1's."""
        return self._advance_slots_chunk([1 if r is not None else 0
                                          for r in self.slot_req])

    # -------------------------------------------------- chunked step paths

    def _chunk_counts(self) -> list[int]:
        """Frames each slot serves in this chunk: the chunk size, or the
        stream's remaining frames (ragged tail).  A slot that completes
        idles to the chunk boundary, masked, and is reset there.  In the
        pipelined contract a live slot never idles: ``ring_frames`` is a
        multiple of ``chunk_frames``, so the fill reaches the watermark at
        a chunk boundary and the flush restores full capacity."""
        counts = []
        for i, r in enumerate(self.slot_req):
            if r is None:
                counts.append(0)
                continue
            n = min(self.chunk_frames, len(r.frames) - self.slot_pos[i])
            if self.pipeline_depth >= 1:
                cap = self.ring_frames - (self.slot_pos[i] - self._flushed[i])
                assert cap >= n, "live slot would idle mid-chunk (ring " \
                    "capacity below a chunk)"
            counts.append(n)
        return counts

    def _chunk_mask(self, counts: list[int]) -> np.ndarray:
        """The (F, slots) fill mask of a chunk: sub-step f of slot i is
        live when ``f < counts[i]``."""
        return np.arange(self.chunk_frames)[:, None] < np.asarray(counts)

    def _stage_chunk(self, counts: list[int]) -> np.ndarray:
        """Stage the next ``counts[i]`` frames of each slot into the (F,
        slots, input_dim) frames, idle sub-steps zero; returns the staged
        control word."""
        x, ctrl = self._stage()
        for i, r in enumerate(self.slot_req):
            if counts[i]:
                p = self.slot_pos[i]
                x[:counts[i], i] = r.frames[p:p + counts[i]]
        return ctrl

    def _dispatch_step_chunk(self, counts: list[int], act: np.ndarray):
        """v1 chunked: the (F, slots) fill mask ``act`` -> (logits (F,
        slots, fc_dim) np, packed masked counter vector)."""
        ctrl = self._stage_chunk(counts)
        ctrl[0] = act
        logits, vec = self._dispatch()
        return logits.cpu().numpy(), vec

    def _dispatch_ring_chunk(self, counts: list[int],
                             ctrl: np.ndarray) -> None:
        """v2 chunked: dispatch one pipelined step over the (2, F, slots)
        control word [fill mask; ring row]; nothing crosses to the
        host."""
        word = self._stage_chunk(counts)
        word[:] = ctrl
        self._dispatch()

    def _step_once_sync_chunk(self) -> bool:
        """v1 at ``chunk_frames > 1``: one dispatch and one logit fetch a
        chunk, the schedule otherwise that of frame-by-frame stepping."""
        counts = self._chunk_counts()
        logits_np, aux_vec = self._dispatch_step_chunk(
            counts, self._chunk_mask(counts))
        self.host_syncs += 1  # per-chunk logit fetch
        self.steps += 1
        self.dispatches += 1
        served = int(sum(counts))
        self.frames_served += served
        if self.counters is not None:
            self.counters.update(
                unpack_step_aux(aux_vec, self.engine.cfg.num_ts),
                active_frames=float(served))
            self.host_syncs += 1
        for i, r in enumerate(self.slot_req):
            if r is None or counts[i] == 0:
                continue
            r.logits.extend(logits_np[:counts[i], i])
            self.slot_pos[i] += counts[i]
            if self.slot_pos[i] == len(r.frames):
                self._finish_slot(i)
                self._reset_slot(i)
        return True

    def _step_once_chunk(self) -> bool:
        """v2 at ``chunk_frames > 1``: one pipeline entry a chunk.  Idle
        sub-steps write the spare ring row ``ring_frames``."""
        counts = self._chunk_counts()
        live = self._chunk_mask(counts)
        base = np.array([self.slot_pos[i] - self._flushed[i]
                         for i in range(self.slots)])
        ctrl = np.zeros((2, *live.shape), np.int32)  # [fill mask; ring row]
        ctrl[0] = live
        ctrl[1] = np.where(live, base + np.arange(self.chunk_frames)[:, None],
                           self.ring_frames)
        self._dispatch_ring_chunk(counts, ctrl)
        self.steps += 1
        self.dispatches += 1
        served = int(sum(counts))
        self.frames_served += served
        if self.counters is not None:
            self._frames_acc += float(served)
        self._push_inflight(self._advance_slots_chunk(counts))
        return True

    def _advance_slots_chunk(self, counts: list[int]) -> list[StreamRequest]:
        """``_advance_slots`` over a per-slot frame count (the chunk's
        fill): the cursors advance by ``counts[i]``, and completion and
        the ring watermark are decided at the chunk boundary."""
        completed = []
        for i, r in enumerate(self.slot_req):
            if r is None or counts[i] == 0:
                continue
            self.slot_pos[i] += counts[i]
            fill = self.slot_pos[i] - self._flushed[i]
            if self.slot_pos[i] == len(r.frames):  # stream complete
                if fill > 0:
                    self._harvest(r, i, fill)
                completed.append(r)
                self._finish_slot(i)
                self._flushed[i] = 0
                self._reset_slot(i)
            elif fill == self.ring_frames:  # watermark flush: ring is full
                self._harvest(r, i, fill)
                self._flushed[i] = self.slot_pos[i]
        return completed

    def _retire(self) -> None:
        """Retire the oldest in-flight step: wait on its fence, then move
        the logits of the streams it completed to the host."""
        step = self._inflight.popleft()
        if step.fence is not None:
            step.fence.synchronize()  # a fence, not a transfer
        for r in step.completed:
            self.host_syncs += r._materialize()
            r.t_harvest = self.clock()

    @property
    def pending_steps(self) -> int:
        """Steps dispatched but not yet retired."""
        return len(self._inflight)

    def flush(self) -> None:
        """Drain the pipeline: retire every in-flight step (materializing
        completed streams' logits) and fold the device counter accumulator
        into ``counters``.  Afterwards ``pending_steps == 0`` and the
        metrics cover every dispatched step.  In-progress streams keep
        their unflushed logits on the device until they complete."""
        while self._inflight:
            self._retire()
        self._drain_aux()

    def run(self) -> list[StreamRequest]:
        """Drain queue, slots and pipeline; returns finished requests in sid
        order, their logits on the host."""
        while self.step_once():
            pass
        self.flush()
        return sorted(self.finished, key=lambda r: r.sid)

    # --------------------------------------------------- measured complexity

    def reset_metrics(self) -> None:
        """Zero the measured-traffic counters (e.g. after a warmup run).
        The accumulator is zeroed in place: a captured step holds it."""
        cfg = self.engine.cfg
        self.counters = (complexity.SparsityCounters(
            num_ts=cfg.num_ts, hidden_dim=cfg.hidden_dim,
            input_dim=cfg.input_dim, input_bits=cfg.input_bits)
            if self.track_sparsity else None)
        self._zero_aux()
        self._frames_acc = 0.0
        self.steps = 0
        self.host_syncs = 0
        self.dispatches = 0  # step dispatches (one a chunk)
        self.frames_served = 0  # slot-frames advanced

    def _drain_aux(self) -> None:
        """Fold the device counter accumulator into ``counters``: one host
        transfer for every step since the last drain."""
        if self.counters is None or self._frames_acc == 0.0:
            return
        self.counters.update(
            unpack_step_aux(self._aux_total(), self.engine.cfg.num_ts),
            active_frames=self._frames_acc)
        self.host_syncs += 1
        self._frames_acc = 0.0
        self._zero_aux()

    def _aux_total(self) -> torch.Tensor:
        """The device counter accumulator to fold into ``counters``."""
        return self._aux_acc

    def _zero_aux(self) -> None:
        """Zero the device counter accumulator in place (a captured step
        holds it); nothing without one."""
        if self._aux_acc is not None:
            self._aux_acc.zero_()

    def _require_counters(self) -> complexity.SparsityCounters:
        if self.counters is None:
            raise ValueError(
                "sparsity tracking is disabled (track_sparsity=False); "
                "construct the loop with track_sparsity=True to measure "
                "profiles/MMAC/s")
        self._drain_aux()
        return self.counters

    def sparsity_profile(self) -> complexity.SparsityProfile:
        return self._require_counters().profile()

    def mmac_per_second(self, fc_prune_frac: float | None = None) -> float:
        """Zero-skip MMAC/s of the traffic served so far (paper Fig. 13), at
        ``fc_prune_frac``, by default the pruning fraction of the model the
        engine serves."""
        counters = self._require_counters()
        if fc_prune_frac is None:
            fc_prune_frac = self.engine.fc_prune_frac
        return counters.mmac_per_second(
            self.engine.cfg, merged_spike=self.engine.cfg.merged_spike,
            fc_prune_frac=fc_prune_frac)
