"""Streaming compressed-RSNN inference engine (frames -> slots -> state).

The serving path for the paper's workload: always-on speech recognition
over 10-ms audio frames, from the pruned int4 model or the float one
(``EngineConfig.precision``, ``"float"`` by default as in the reference).

1. **Frames.** Audio arrives as per-utterance feature sequences
   ``(T, input_dim)``, quantized to the 8-bit fixed-point input format with
   a static calibrated scale (``quantize_features``).
2. **Slots.** ``StreamLoop`` packs N concurrent utterances into a fixed
   batch of ``batch_slots`` slots.  Every step advances each active slot by
   one frame; a finished slot has its recurrent state zeroed
   (``reset_slot``) and is refilled from the queue without stopping the
   batch.
3. **State.** ``CompiledRSNN`` carries ``RSNNState`` (per-ts spikes + LIF
   membrane chain) across frames, wrapped in ``DeltaRSNNState`` (held
   input, cached L0 pre-activation) when the backend gates its input.
   Each frame is the L0 cell, the L1 cell and the FC readout, composed
   from the op table that the backend registry (``serving/backends.py``)
   resolved at construction, or, for ``fused``/``fused_spike``, one
   mega-step launch that does all three (``CompiledRSNN._chunk_step``
   runs F frames in one).

The port runs the reference's synchronous v1 contract (one logit fetch and
one counter fetch per step) at one frame per step.  The pipelined v2
contract (``pipeline_depth > 0``) and the loop's frame chunking
(``chunk_frames > 1``) are not ported yet (ROADMAP).

Entry points (``CompiledRSNN``, ``CompiledRSNN.from_artifact``,
``StreamLoop`` through its engine) run on ``device="cuda"`` unless the
caller asks for ``device="cpu"``; with no GPU present the default raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import complexity
from repro_torch.core import lif as lif_lib
from repro_torch.core import rsnn, spike_ops
from repro_torch.core.layouts.nm import NMGroupPacked, entry_rows
from repro_torch.core.lif import LIFParams, LIFState
from repro_torch.core.rsnn import RSNNConfig, RSNNState
from repro_torch.core.sparse import PackedRSNN, SparseColumns, dequantize
from repro_torch.serving import backends
from repro_torch.serving.slots import SlotScheduler

_V2 = "ROADMAP queue 1, P7 (slot loop v2, chunking)"


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


def _zero_slot(t: torch.Tensor, dim: int, i: int) -> torch.Tensor:
    t = t.clone()
    t.select(dim, i).zero_()
    return t


def reset_slot(state, i: int):
    """Zero one slot's recurrent state (fresh utterance boundary), and for
    a ``DeltaRSNNState`` its held input and cached pre-activation too: a
    fresh utterance must not inherit the previous occupant's.  Returns a
    new state; the tensors of ``state`` are left as they were."""
    if isinstance(state, DeltaRSNNState):
        return DeltaRSNNState(rsnn=reset_slot(state.rsnn, i),
                              x_prev=_zero_slot(state.x_prev, 0, i),
                              pre=_zero_slot(state.pre, 0, i))

    def zl(s: LIFState) -> LIFState:
        return LIFState(u=_zero_slot(s.u, 0, i),
                        spike=_zero_slot(s.spike, 0, i))

    return RSNNState(h0=_zero_slot(state.h0, 1, i),
                     h1=_zero_slot(state.h1, 1, i),
                     lif0=zl(state.lif0), lif1=zl(state.lif1))


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no GPU present
    raises instead of carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch serves on a CUDA device and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions on the CPU")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; use cuda or cpu")
    return device


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
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, device) for v in tree))
    return tree


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
    ``engine.precision="float"``, the packed int4 model at ``"int4"``; the
    static input scale and the op table of its backend.  State threads
    through explicitly so callers control the frame/slot lifecycle.
    """

    def __init__(self, cfg: RSNNConfig, params: dict | None,
                 engine: EngineConfig = EngineConfig(), *,
                 packed: PackedRSNN | None = None,
                 device: torch.device | str = "cuda",
                 fc_prune_frac: float = 0.0):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.engine = engine
        if (params is None) == (packed is None):
            raise ValueError("CompiledRSNN needs exactly one payload: float "
                             "params or a packed int4 model (packed=)")
        if engine.precision == "int4":
            if packed is None:
                raise ValueError(
                    "int4 precision needs the packed model (packed=); "
                    "packing float params is not ported (ROADMAP queue 1 "
                    "item 6)")
            dense, quant, sparse = self._load_int4(cfg, packed, engine)
        else:
            if params is None:
                raise ValueError("float precision needs the parameter dict "
                                 "(params), not a packed model")
            if fc_prune_frac:
                raise ValueError("a float model has no pruned FC; "
                                 f"fc_prune_frac must be 0, got "
                                 f"{fc_prune_frac}")
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
        self.fc_prune_frac = fc_prune_frac
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
            return cls(art.cfg, None, engine, packed=art.packed,
                       device=device, fc_prune_frac=art.fc_prune_fraction)
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

    Lifecycle timestamps (``StreamLoop.clock``, monotonic seconds):
    ``t_submit`` at enqueue, ``t_start`` when the stream takes a slot,
    ``t_done`` when its last frame is served and ``t_harvest`` when its
    logits are on the host — the same moment in the synchronous contract.
    """

    sid: int
    frames: np.ndarray  # (T, input_dim) raw features
    fc_dim: int = 0  # logit width, stamped by StreamLoop.submit
    logits: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float | None = None
    t_start: float | None = None
    t_done: float | None = None
    t_harvest: float | None = None

    def stacked_logits(self) -> np.ndarray:
        if not self.logits:
            return np.zeros((0, self.fc_dim), np.float32)
        return np.stack(self.logits)


class StreamLoop(SlotScheduler):
    """Continuous batching of audio streams over recurrent-state slots.

    N submitted utterances share a fixed batch of ``batch_slots`` rows.
    Each ``step_once`` advances every active slot by one frame; a slot
    whose utterance ends is state-reset and refilled from the queue
    mid-batch.  Idle slots carry zero frames and are excluded from the
    sparsity counters.  This is the synchronous v1 contract: the logits
    and the packed counter vector cross to the host every step
    (``host_syncs``).  ``pipeline_depth`` and ``chunk_frames`` other than
    0 and 1 are not ported yet and raise.
    """

    def __init__(self, engine: CompiledRSNN, batch_slots: int = 4,
                 pipeline_depth: int = 0, chunk_frames: int = 1):
        super().__init__(batch_slots)
        if pipeline_depth < 0:
            raise ValueError(f"pipeline_depth must be >= 0, "
                             f"got {pipeline_depth}")
        if chunk_frames < 1:
            raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
        if pipeline_depth != 0:
            raise NotImplementedError(
                f"pipeline_depth={pipeline_depth}: the pipelined v2 loop is "
                f"not yet ported to repro_torch ({_V2}); use 0")
        if chunk_frames != 1:
            raise NotImplementedError(
                f"chunk_frames={chunk_frames}: frame-chunked dispatch is not "
                f"yet ported to repro_torch ({_V2}); use 1")
        self.engine = engine
        self.pipeline_depth = pipeline_depth
        self.chunk_frames = chunk_frames
        self.clock = time.monotonic  # swappable for deterministic tests
        self.state = engine.init_state(batch_slots)
        self.reset_metrics()

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
        """Fresh utterance boundary: zero the slot's recurrent state."""
        req.t_start = self.clock()
        self.state = reset_slot(self.state, i)

    def _finish_slot(self, i: int) -> StreamRequest:
        req = super()._finish_slot(i)
        req.t_done = req.t_harvest = self.clock()
        return req

    # ------------------------------------------------------------ step path

    def _gather_host_frames(self) -> np.ndarray:
        """Host-side frame assembly: idle slots carry zero frames (the
        counter masking keys off the active mask, not this zeroing)."""
        x = np.zeros((self.slots, self.engine.cfg.input_dim), np.float32)
        for i, r in enumerate(self.slot_req):
            if r is not None:
                x[i] = r.frames[self.slot_pos[i]]
        return x

    def _dispatch_step(self, active: np.ndarray):
        """Advance the engine one frame over all slots.  Returns (logits
        (slots, fc_dim) np, packed masked counter vector)."""
        dev = self.engine.device
        x = torch.from_numpy(self._gather_host_frames()).to(dev)
        act = torch.from_numpy(active).to(dev)
        self.state, logits, aux_vec = self.engine.step_masked(
            self.state, self.engine._quantize(x), act)
        return logits.cpu().numpy(), aux_vec

    def step_once(self) -> bool:
        """One engine step over all slots; returns False when fully drained
        (empty queue and empty slots)."""
        self._refill()
        active = self.active_mask()
        if not active.any():
            return False
        logits_np, aux_vec = self._dispatch_step(active)
        self.host_syncs += 1  # per-frame logit fetch
        self.steps += 1
        self.frames_served += int(active.sum())
        self.counters.update(unpack_step_aux(aux_vec, self.engine.cfg.num_ts),
                             active_frames=float(active.sum()))
        self.host_syncs += 1  # per-frame counter fetch
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            r.logits.append(logits_np[i])
            self.slot_pos[i] += 1
            if self.slot_pos[i] == len(r.frames):
                self._finish_slot(i)
                self.state = reset_slot(self.state, i)
        return True

    def run(self) -> list[StreamRequest]:
        """Drain queue and slots; returns finished requests in sid order."""
        while self.step_once():
            pass
        return sorted(self.finished, key=lambda r: r.sid)

    # --------------------------------------------------- measured complexity

    def reset_metrics(self) -> None:
        """Zero the measured-traffic counters (e.g. after a warmup run)."""
        cfg = self.engine.cfg
        self.counters = complexity.SparsityCounters(
            num_ts=cfg.num_ts, hidden_dim=cfg.hidden_dim,
            input_dim=cfg.input_dim, input_bits=cfg.input_bits)
        self.steps = 0
        self.host_syncs = 0
        self.frames_served = 0  # slot-frames advanced

    def sparsity_profile(self) -> complexity.SparsityProfile:
        return self.counters.profile()

    def mmac_per_second(self) -> float:
        """Zero-skip MMAC/s of the traffic served so far (paper Fig. 13),
        at the pruning fraction of the model the engine serves."""
        return self.counters.mmac_per_second(
            self.engine.cfg, merged_spike=self.engine.cfg.merged_spike,
            fc_prune_frac=self.engine.fc_prune_frac)
