"""Named execution backends for the streaming RSNN engine.

A backend is a named recipe that, given the deployed weight bundle
(``BackendContext``), returns a uniform ``OpTable``:

  * ``rsnn_cell`` — fused recurrent spiking layer step (TS parallel);
  * ``ff_matmul`` — per-layer feedforward stimulus ``x @ W`` (dense
    float or dequantized weights, or the int4 kernel on the packed
    nibbles);
  * ``fc``        — the readout over the TS spike trains (merged-spike
    int4, per-ts int4, the packed layout's zero-skip path, or the dense
    float32 FC);
  * ``delta_gate`` — set by ``delta`` only: ``(x_t, x_prev, pre_prev) ->
    (x_hat, pre, mask)``, run before the cells; ``pre`` replaces the L0
    feedforward stimulus and the engine carries ``x_hat``/``pre`` per slot
    (``stream.DeltaRSNNState``);
  * ``megastep``  — set by ``fused``/``fused_spike`` only: ``(state,
    x_chunk (F, B, D), lif) -> (state, logits (F, B, N), aux)``, the whole
    frame step of F frames in one call; the three entries above then
    raise.

The zero-skip readout is layout-dispatched: the packed FC tensor's type
resolves its ``core/layouts`` ``WeightLayout`` and the backend binds the
layout's plain oracle (``ref``) or its kernel (``cuda``/``sparse``).

Every backend but ``sparse`` serves both precisions.  At ``float`` the
weights are the raw float32 matrices: the feed-forward stimuli and the
readout are dense ``torch.matmul`` products (the reference computes them
outside any Pallas kernel too), the cells keep their kernels (K1, K10),
``spike`` gathers the float FC through K9, ``delta`` gates through K8, and
``fused``/``fused_spike`` launch K6/K7 with float weights and the
``dense_float`` FC.

Built-in backends:

  ``ref`` (alias ``jnp``)    — the plain PyTorch versions in
      ``kernels/ref.py`` over dense (dequantized) weights; with
      ``sparse_fc`` the readout is the packed layout's plain oracle.
  ``cuda`` (alias ``pallas``) — the hand-written kernels through
      ``kernels/ops.py``: a CUDA kernel on CUDA tensors, the plain
      version on CPU tensors.  The alias keeps the backend name stored in
      the reference's artifacts resolvable.
  ``sparse``                 — ``cuda`` plus the packed FC layout's
      zero-skip kernel (K4 ``kernels/sparse_fc.py`` for padded CSC, K5
      ``kernels/nm_fc.py`` for the group-packed N:M layout).
  ``spike``                  — activation-side zero skip: both recurrent
      cells through K10 ``spike_cell`` and the L1 feedforward through K9
      ``spike_broadcast``, over ascending event lists of
      ``ctx.spike_capacity`` slots (``None``: lossless).
  ``delta``                  — the ``ref`` table plus the K8 ``delta_step``
      gate over the L0 feedforward, with the cells through K10.

  ``fused``                  — the whole frame step (both cells, the
      packed layout's FC, the sparsity counters) in one K6 ``megastep``
      launch a frame, or a chunk of frames.
  ``fused_spike``            — ``fused`` through K7, the mega-step whose
      spike-consuming products run over lossless event lists.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.core import layouts, spike_ops
from repro_torch.core.layouts.dense import dequantize
from repro_torch.core.lif import LIFState
from repro_torch.core.rsnn import RSNNConfig, RSNNState
from repro_torch.kernels import ops, ref


@dataclasses.dataclass(frozen=True)
class BackendContext:
    """The deployed weight bundle an OpTable is resolved against.

    At ``precision="int4"``, ``dense`` holds the dequantized float32
    matrices of the ops that consume dense weights, ``quant`` the packed
    int4 tensors and ``sparse`` each pruned tensor's layout-resolved
    packed form.  At ``"float"``, ``dense`` holds every float32 matrix of
    the model (``fc_w`` included) and ``quant``/``sparse`` are empty.
    """

    cfg: RSNNConfig
    precision: str  # "float" | "int4"
    sparse_fc: bool  # zero-skip layout readout instead of the dense FC
    dense: dict  # name -> (K, N) float32
    quant: dict  # name -> layouts.dense.QuantTensor
    sparse: dict  # name -> layout tensor (SparseColumns, NMGroupPacked)
    delta_threshold: float = 0.0  # delta backend's |x_t - x_prev| gate
    spike_capacity: int | None = None  # event-list slots (None = lossless)


class OpTable(NamedTuple):
    """Uniform per-backend op set consumed by ``CompiledRSNN``."""

    name: str
    rsnn_cell: Callable  # (stim, s_prev, w, u0, h0, beta, vth) -> (s, u)
    ff_matmul: Callable  # (x2d (M, K), layer_name) -> (M, N)
    fc: Callable  # (spikes_ts (TS, B, H)) -> (B, fc_dim)
    # (x_t, x_prev, pre_prev) -> (x_hat, pre, mask); set by ``delta`` only
    delta_gate: Callable | None = None
    # (state, x_chunk, lif) -> (state, logits, aux); set by ``fused*`` only
    megastep: Callable | None = None


class _Entry(NamedTuple):
    builder: Callable  # BackendContext -> OpTable
    dense_stimulus: bool  # int4 ff_matmul consumes dense dequant weights


_REGISTRY: dict[str, _Entry] = {}


def register(name: str, *aliases: str, dense_stimulus: bool = False):
    """Decorator: register an OpTable builder under ``name`` (+ aliases).

    ``dense_stimulus=True`` declares that at int4 the backend's
    ``ff_matmul`` reads dense dequantized weights (so the engine must
    materialize them) rather than the packed nibbles.
    """

    def deco(builder: Callable[[BackendContext], OpTable]):
        for key in (name, *aliases):
            _REGISTRY[key] = _Entry(builder, dense_stimulus)
        return builder

    return deco


def available() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def unregister(name: str) -> None:
    """Remove a registered backend (a bench- or test-local plugin); a name
    that is not registered is left alone."""
    _REGISTRY.pop(name, None)


def _entry(name: str) -> _Entry:
    if name not in _REGISTRY:
        raise ValueError(f"unknown backend {name!r}; available: "
                         f"{available()}")
    return _REGISTRY[name]


def needs_dense_stimulus(name: str) -> bool:
    """Whether backend ``name``'s int4 feedforward path wants dense weights."""
    return _entry(name).dense_stimulus


def resolve(name: str, ctx: BackendContext) -> OpTable:
    """Build the op table of backend ``name`` over the weight bundle."""
    return _entry(name).builder(ctx)


# ------------------------------------------------------------ op resolution


def _dense_ff(ctx: BackendContext) -> Callable:
    def ff(x2d: torch.Tensor, name: str) -> torch.Tensor:
        return x2d @ ctx.dense[name]

    return ff


def _fc_op(ctx: BackendContext, *, mfc: Callable, i4mm: Callable,
           fused: bool) -> Callable:
    """Resolve the readout: layout zero-skip > packed int4 > dense float.

    The zero-skip path dispatches on the packed FC tensor's layout.
    ``fused=True`` binds the layout's kernel, ``False`` its plain oracle.
    The float readout is a dense ``torch.matmul`` product, as the
    reference's (no Pallas kernel there either).
    """
    if ctx.sparse_fc:
        t = ctx.sparse["fc_w"]
        layout = layouts.layout_of(t)
        fc_fn = layout.fc_kernel if fused else layout.fc_oracle
        return lambda s1: fc_fn(s1, t)
    if ctx.precision == "int4":
        qt = ctx.quant["fc_w"]
        scale = qt.scale.reshape(-1)
        if ctx.cfg.merged_spike:
            return lambda s1: mfc(s1, qt.packed, scale)
        return lambda s1: sum(i4mm(s1[t], qt.packed, scale)
                              for t in range(ctx.cfg.num_ts))
    w = ctx.dense["fc_w"]
    if ctx.cfg.merged_spike:
        return lambda s1: spike_ops.merged_spike_fc(s1, w)
    return lambda s1: (s1 @ w).sum(dim=0)


# ------------------------------------------------------- built-in backends


@register("ref", "jnp", dense_stimulus=True)
def _build_ref(ctx: BackendContext) -> OpTable:
    fc = _fc_op(ctx, mfc=ref.merged_spike_fc_ref, i4mm=ref.int4_matmul_ref,
                fused=False)
    return OpTable(name="ref", rsnn_cell=ref.rsnn_cell_ref,
                   ff_matmul=_dense_ff(ctx), fc=fc)


@register("cuda", "pallas")
def _build_cuda(ctx: BackendContext) -> OpTable:
    if ctx.precision == "int4":
        def ff(x2d: torch.Tensor, name: str) -> torch.Tensor:
            qt = ctx.quant[name]
            return ops.int4_matmul(x2d, qt.packed, qt.scale.reshape(-1))
    else:
        ff = _dense_ff(ctx)

    fc = _fc_op(ctx, mfc=ops.merged_spike_fc, i4mm=ops.int4_matmul,
                fused=True)
    return OpTable(name="cuda", rsnn_cell=ops.rsnn_cell, ff_matmul=ff, fc=fc)


@register("sparse")
def _build_sparse(ctx: BackendContext) -> OpTable:
    """``cuda`` cells/stimulus + the packed layout's zero-skip readout."""
    ctx = dataclasses.replace(ctx, sparse_fc=True)
    return _build_cuda(ctx)._replace(name="sparse")


@register("spike", dense_stimulus=True)
def _build_spike(ctx: BackendContext) -> OpTable:
    """Event-driven spike-broadcast path: input-side zero skipping.

    Every spike-consuming matmul runs over ascending-index event lists:
    both recurrent cells through K10 ``spike_cell``, the L1 feedforward
    through K9 ``spike_broadcast``.  The L0 stimulus consumes the analog
    input, not spikes, and stays a dense ``x @ W`` over the dense
    (dequantized at int4) weights, as in the reference (outside any Pallas kernel there too).
    The readout is the packed layout's zero-skip kernel with
    ``sparse_fc`` (K4 for CSC, K5 for N:M); otherwise K9's merged-spike-union path
    (a 3-D input) over the dense FC weights (dequantized once at int4), or
    one K9 call per time step for a config without merged spikes (summed
    as the reference sums them at each precision).
    """
    cfg, cap, dense = ctx.cfg, ctx.spike_capacity, ctx.dense
    cell = functools.partial(ops.spike_cell, capacity=cap)

    def ff(x2d: torch.Tensor, name: str) -> torch.Tensor:
        if name == "l1_wx":  # spike-consuming: gather over spike events
            return ops.spike_broadcast(x2d, dense[name], capacity=cap)
        return x2d @ dense[name]  # analog input stimulus: dense

    if ctx.sparse_fc:
        t = ctx.sparse["fc_w"]
        fc_fn = layouts.layout_of(t).fc_kernel
        fc = lambda s1: fc_fn(s1, t)  # noqa: E731
    else:
        w_fc = (dequantize(ctx.quant["fc_w"]) if ctx.precision == "int4"
                else dense["fc_w"])
        if cfg.merged_spike:
            fc = lambda s1: ops.spike_broadcast(  # noqa: E731
                s1, w_fc, capacity=cap)
        elif ctx.precision == "int4":
            fc = lambda s1: sum(  # noqa: E731
                ops.spike_broadcast(s1[t], w_fc, capacity=cap)
                for t in range(cfg.num_ts))
        else:
            fc = lambda s1: torch.stack([  # noqa: E731
                ops.spike_broadcast(s1[t], w_fc, capacity=cap)
                for t in range(cfg.num_ts)]).sum(dim=0)
    return OpTable(name="spike", rsnn_cell=cell, ff_matmul=ff, fc=fc)


@register("delta", dense_stimulus=True)
def _build_delta(ctx: BackendContext) -> OpTable:
    """EdgeDRNN-style delta-temporal zero skipping over the ``ref`` table.

    ``delta_gate`` is K8 ``delta_step`` over the dense (dequantized at
    int4) L0 feedforward weights: the engine carries each slot's held input and
    cached L0 pre-activation (``stream.DeltaRSNNState``), and only a slot
    with a propagated element (``|x_t - x_prev| > ctx.delta_threshold``)
    recomputes its row.  Both cells run through K10 ``spike_cell``, the
    spike-domain gate of the recurrent operand.  The L1 feedforward
    (``x @ W``) and the readout (the layout's ``fc_oracle``, or
    ``merged_spike_fc_ref``) are the ``ref`` table's plain PyTorch: the
    reference computes them outside any Pallas kernel too, so this is the
    backend's definition, not a fallback.
    """
    w0x = ctx.dense["l0_wx"]
    thr = float(ctx.delta_threshold)
    cell = functools.partial(ops.spike_cell, capacity=ctx.spike_capacity)

    def delta_gate(x_t, x_prev, pre_prev):
        return ops.delta_step(x_t, x_prev, pre_prev, w0x, thr)

    return _build_ref(ctx)._replace(name="delta", rsnn_cell=cell,
                                    delta_gate=delta_gate)


@register("fused")
def _build_fused(ctx: BackendContext) -> OpTable:
    """Single-launch mega-step: the op table collapses to one call.

    Both cells, the layout-resolved zero-skip FC and the sparsity counters
    run inside one K6 ``megastep`` launch a frame (or a chunk of frames)
    with the recurrent state held on chip; the per-op entries raise.  At
    int4 the layer weights go in packed and the FC operands come from the
    packed tensor's ``WeightLayout.megastep_fc`` binding (``dense_int4``,
    ``csc``, or ``nm`` with its ``nm_n``/``nm_m`` statics); at float the
    four float32 layer matrices and the ``dense_float`` FC.
    """
    return _fused_table(ctx, spike=False)


@register("fused_spike")
def _build_fused_spike(ctx: BackendContext) -> OpTable:
    """The mega-step in its spike mode (K7): one launch a frame, with the
    three spike-consuming products and the dense FC over lossless event
    lists; bit-equal to ``fused`` on the same inputs."""
    return _fused_table(ctx, spike=True)


def _fused_table(ctx: BackendContext, *, spike: bool) -> OpTable:
    name = "fused_spike" if spike else "fused"
    cfg = ctx.cfg
    if not cfg.merged_spike:
        raise ValueError(
            f"the {name!r} backend's mega-step kernel implements the "
            "merged-spike readout (paper §II-D2); per-ts readout needs "
            "another backend")
    names = ("l0_wx", "l0_wh", "l1_wx", "l1_wh")
    if ctx.precision == "int4":
        wargs = tuple(a for n in names
                      for a in (ctx.quant[n].packed, ctx.quant[n].scale))
        fct = ctx.sparse["fc_w"] if ctx.sparse_fc else ctx.quant["fc_w"]
        fc_mode, fcargs, statics = layouts.layout_of(fct).megastep_fc(fct)
    else:
        wargs = tuple(ctx.dense[n] for n in names)
        fc_mode, fcargs, statics = "dense_float", (ctx.dense["fc_w"],), {}

    def megastep(state: RSNNState, x_chunk: torch.Tensor, lif: dict):
        # the kernel's h0/h1 are the LIF carries' last spikes
        s0, u0, s1, u1, logits, sp0, sp1, union, bits = ops.megastep(
            x_chunk, state.h0, state.lif0.u, state.lif0.spike,
            state.h1, state.lif1.u, state.lif1.spike,
            lif["beta0"], lif["vth0"], lif["beta1"], lif["vth1"],
            wargs, fcargs, fc_mode=fc_mode, input_bits=cfg.input_bits,
            precision=ctx.precision, spike=spike, **statics)
        new_state = RSNNState(h0=s0, h1=s1,
                              lif0=LIFState(u=u0, spike=s0[-1]),
                              lif1=LIFState(u=u1, spike=s1[-1]))
        zero = torch.zeros_like(bits)  # no delta gating in the mega-step
        aux = {"spikes_l0": sp0, "spikes_l1": sp1, "union_l1": union,
               "input_one_bits": bits, "delta_propagated": zero,
               "delta_skipped": zero}
        return new_state, logits, aux

    def _collapsed(op: str) -> Callable:
        def call(*_a, **_k):
            raise RuntimeError(
                f"the {name!r} backend executes the whole frame step as "
                f"one megastep launch; {op!r} is not separately callable")

        return call

    return OpTable(name=name, rsnn_cell=_collapsed("rsnn_cell"),
                   ff_matmul=_collapsed("ff_matmul"), fc=_collapsed("fc"),
                   megastep=megastep)
