"""K6 and K7 wrapper: the whole frame step over an F-frame chunk in one
launch (``csrc/megastep.cu``).

Replaces ``src/repro/kernels/megastep.py`` ``megastep`` (its
``pl.pallas_call`` at line 250): K6 is its ``spike=False`` mode, K7 its
``spike=True`` mode, each at both precisions of the layer weights
(``int4``: packed nibbles and scales, with the ``dense_int4``, ``csc`` or
``nm`` FC; ``float``: four float32 matrices, with the float32
``dense_float`` FC).  The plain version is ``ref.megastep_ref``; the
membrane potentials agree within the tolerance stated in
``chip_smoke.py`` and the tests (float32 sums in another order), the
counters exactly, the int4 logits bit for bit given equal merged spikes
and the float logits within that tolerance.  K7 is bit-equal to K6 on the
same inputs.  ``launches`` counts K6's launches of this process,
``spike_launches`` K7's.

The kernel runs one thread-block cluster for each tile of 32 slots: its
``cluster`` CTAs split the hidden columns of both layers and exchange their
new spikes through distributed shared memory, then split the FC's output
columns, ``cols`` at a time.  ``tile_plans`` lists the plans the launch
takes for a shape with each CTA's shared memory (``MegaLayout`` in the
source), ``tile_plan`` ranks them, and on the card ``resident_plan`` ranks
those that fit by how many waves their clusters take
(``cudaOccupancyMaxActiveClusters``) within each sub-tile width.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

launches = 0  # K6 megastep(spike=False)
spike_launches = 0  # K7 megastep(spike=True)

# the kernel's codes: FC modes, and precisions of the layer weights
FC_MODES = {"dense_int4": 0, "csc": 1, "nm": 2, "dense_float": 3}
PRECISIONS = {"int4": 0, "float": 1}
# megastep_launch's C signature: 19 state/weight pointers, precision,
# fc_mode, 3 FC and 9 output pointers, then frames, ts, b, d, h, fc, nnz,
# nm_n, nm_m, input_bits, spike, the plan's rows, cluster and cols, and the
# stream
_ARGS = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 12
         + [ctypes.c_int] * 14 + [ctypes.c_void_p])
# megastep_plan_info's: ts, d, h, precision, fc_mode, nnz, nm_n, nm_m,
# spike, b, rows, cluster, cols, and an int[2] it fills
_INFO_ARGS = [ctypes.c_int] * 13 + [ctypes.c_void_p]

SLOTS = 32  # slots a cluster (the FC gather's lanes)
CLUSTERS = (16, 8)  # CTAs a cluster, in the order tile_plan prefers them
COLS = (128, 64, 32, 16)  # FC columns a sub-tile, likewise


class MegaPlan(NamedTuple):
    """One launch's plan: ``rows`` slots a cluster of ``cluster`` CTAs,
    ``cols`` FC columns a sub-tile, the grid's ``ctas`` and a CTA's
    ``shared_bytes``."""

    rows: int
    cluster: int
    cols: int
    ctas: int
    shared_bytes: int


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def shared_bytes(ts: int, d: int, h: int, fc_mode: str, entries: int,
                 spike: bool, cluster: int, cols: int) -> int:
    """A CTA's shared memory as ``MegaLayout`` computes it: the layer
    slices (float32; or, int4, L0's input slice in float32 and the others'
    bit planes and int8 nibbles) and their scales, two frames' inputs, the
    trains as bits (two buffers), K7's event lists, the merged spikes and
    the FC sub-tile as staged and as multiplied, with its scales
    (``entries``: the CSC or N:M entries a column; the dense FCs take
    H)."""
    hcp = 8
    while hcp < -(-h // cluster):
        hcp *= 2
    hp = -(-cluster * hcp // 32) * 32
    ld = hp + 16
    float_fc = fc_mode == "dense_float"
    e = h if fc_mode in ("dense_int4", "dense_float") else entries
    tile = e * cols
    raw = {"csc": 8 * tile, "nm": tile, "dense_int4": h // 2 * cols,
           "dense_float": 4 * tile}[fc_mode]
    slices = (_a16(4 * (d + 3 * hp) * hcp) if float_fc else
              _a16(4 * d * hcp) + _a16(16 * 3 * (hp // 32) * hcp)
              + _a16(3 * hp * hcp) + _a16(4 * 4 * hcp))
    fixed = (slices + _a16(4 * 2 * SLOTS * d)
             + _a16(4 * 4 * ts * SLOTS * (hp // 32)))
    if spike:
        fixed += _a16(2 * ts * SLOTS * (hp + 4)) + _a16(4 * (2 * ts * SLOTS
                                                            + 1))
        fixed += _a16(hp) if float_fc else 0
    fixed += _a16(4 * hp * SLOTS if float_fc else SLOTS * ld)
    fc = (_a16(raw) + _a16(4 * tile if float_fc else cols * ld)
          + (0 if float_fc else _a16(8 * cols)))
    nibbles = _a16((d // 2 + 3 * (hp // 2)) * hcp)
    return fixed + max(fc, nibbles)


def tile_plans(ts: int, b: int, d: int, h: int, fc_mode: str,
               entries: int, spike: bool) -> list[MegaPlan]:
    """Every plan the launch takes for this shape: 128, 64, 32 or 16 FC
    columns a sub-tile (16 leaves half the gather's warps idle: for shapes
    nothing wider fits), each over clusters of 16 or 8 CTAs of 32 slots."""
    return [MegaPlan(SLOTS, c, cols, -(-b // SLOTS) * c,
                     shared_bytes(ts, d, h, fc_mode, entries, spike, c, cols))
            for cols in COLS for c in CLUSTERS]


@functools.lru_cache(maxsize=256)
def tile_plan(ts: int, b: int, d: int, h: int, fc_mode: str, entries: int,
              spike: bool) -> MegaPlan:
    """The first of ``tile_plans`` whose shared memory fits a CTA: the
    widest sub-tile (fewer passes over the FC; the first is staged while
    the cells run), then the larger cluster (more CTAs on the SMs).  When
    none fits, the smallest, which the launch refuses (status -2)."""
    plans = tile_plans(ts, b, d, h, fc_mode, entries, spike)
    fits = [p for p in plans if p.shared_bytes <= _build.MAX_SHARED_BYTES]
    return fits[0] if fits else min(plans, key=lambda p: p.shared_bytes)


def plan_info(plan: MegaPlan, ts: int, b: int, d: int, h: int,
              precision: str, fc_mode: str, entries: int, nm_n: int,
              nm_m: int, spike: bool) -> tuple[int, int]:
    """(shared bytes a CTA, clusters the card holds at once) of ``plan``,
    from the launch's own code; raises where the launch would refuse it."""
    info = (ctypes.c_int * 2)()
    fn = _build.function("megastep_plan_info", _INFO_ARGS)
    _build.check(fn(ts, d, h, PRECISIONS[precision], FC_MODES[fc_mode],
                    entries, int(nm_n), int(nm_m), int(spike), b, plan.rows,
                    plan.cluster, plan.cols, ctypes.addressof(info)),
                 "megastep")
    return info[0], info[1]


_resident: dict[tuple, MegaPlan] = {}


def resident_plan(ts: int, b: int, d: int, h: int, precision: str,
                  fc_mode: str, entries: int, nm_n: int, nm_m: int,
                  spike: bool) -> MegaPlan:
    """The plan a launch on the card takes: among the plans that fit, the
    widest sub-tile, then the fewest waves of the ceil(b / 32) clusters
    over those the card holds at once, then the larger cluster;
    ``tile_plan``'s when none fits.  Cached per shape.  (On an H100 at
    B = 256 this picks the fastest plan of ``chip_smoke.py
    --sweep-tiles``, or one within 2% of it, in every FC mode.)"""
    key = (ts, b, d, h, precision, fc_mode, entries, nm_n, nm_m, spike)
    plan = _resident.get(key)
    if plan is None:
        fits = [p for p in tile_plans(ts, b, d, h, fc_mode, entries, spike)
                if p.shared_bytes <= _build.MAX_SHARED_BYTES]
        need = -(-b // SLOTS)

        def rank(p: MegaPlan) -> tuple:
            held = plan_info(p, ts, b, d, h, precision, fc_mode, entries,
                             nm_n, nm_m, spike)[1]
            waves = -(-need // held) if held else need + 1
            return -p.cols, waves, -p.cluster

        plan = min(fits, key=rank) if fits else tile_plan(
            ts, b, d, h, fc_mode, entries, spike)
        _resident[key] = plan
    return plan


def _fc_operands(fc_mode: str, fcargs: tuple, h: int) -> tuple:
    """The FC operands as the kernel takes them, after checking their
    dtypes and shapes: (a, values or None, scale (N,) or None, N, nnz),
    where ``nnz`` counts the CSC entries or the N:M entry slots of a
    column."""
    if fc_mode not in FC_MODES:
        raise ValueError(f"megastep: unknown fc_mode {fc_mode!r}; the kernel "
                         f"serves {sorted(FC_MODES)}")
    if fc_mode == "dense_float":
        (w_fc,) = fcargs
        if w_fc.dtype != torch.float32 or w_fc.dim() != 2 \
                or w_fc.shape[0] != h:
            raise ValueError(f"megastep: dense_float FC must be float32 "
                             f"({h}, N), got {w_fc.dtype} "
                             f"{tuple(w_fc.shape)}")
        return w_fc.contiguous(), None, None, w_fc.shape[1], 0
    if fc_mode == "dense_int4":
        packed, scale = fcargs
        n = packed.shape[-1]
        if packed.dtype != torch.int8 or packed.shape != (h // 2, n):
            raise ValueError(f"megastep: dense_int4 FC packed must be int8 "
                             f"({h // 2}, N), got {packed.dtype} "
                             f"{tuple(packed.shape)}")
        a, values, nnz = packed, None, 0
    elif fc_mode == "nm":
        packed, scale = fcargs
        nnz, n = packed.shape
        if packed.dtype != torch.int8:
            raise ValueError(f"megastep: nm FC packed must be int8, got "
                             f"{packed.dtype}")
        a, values = packed, None
    else:
        indices, values, scale = fcargs
        nnz, n = indices.shape
        if indices.dtype != torch.int32 or values.dtype != torch.float32 \
                or values.shape != indices.shape:
            raise ValueError(f"megastep: csc FC needs int32 indices and "
                             f"float32 values of one shape, got "
                             f"{indices.dtype} {tuple(indices.shape)} and "
                             f"{values.dtype} {tuple(values.shape)}")
        a, values = indices, values.contiguous()
    if scale.dtype != torch.float32 or scale.numel() != n:
        raise ValueError(f"megastep: FC scale must be float32 with {n} "
                         f"values, got {scale.dtype} {tuple(scale.shape)}")
    return a.contiguous(), values, scale.reshape(n).contiguous(), n, nnz


def _layer_weights(wargs: tuple, precision: str, d: int, h: int,
                   dev) -> list:
    """The four layer weights as the kernel's eight weight pointers, after
    checking them: int4 (int8 (K/2, H), float32 (H,) or (1, H)) pairs, or
    float32 (K, H) matrices, each followed by no scale (None)."""
    f32, ks = torch.float32, (d, h, h, h)
    w = []
    if precision == "float":
        if len(wargs) != 4:
            raise ValueError(f"megastep: float wargs holds four matrices, "
                             f"got {len(wargs)} tensors")
        for i, (k, m) in enumerate(zip(ks, wargs)):
            if m.dtype != f32 or m.shape != (k, h) or m.device != dev:
                raise ValueError(
                    f"megastep: weight {i} must be float32 ({k}, {h}) on "
                    f"{dev}, got {m.dtype} {tuple(m.shape)} on {m.device}")
            w += [m.contiguous(), None]
        return w
    if len(wargs) != 8:
        raise ValueError(f"megastep: int4 wargs holds four (q, scale) pairs, "
                         f"got {len(wargs)} tensors")
    for i, k in enumerate(ks):
        q, sc = wargs[2 * i], wargs[2 * i + 1]
        if q.dtype != torch.int8 or q.shape != (k // 2, h) \
                or sc.dtype != f32 or sc.numel() != h \
                or q.device != dev or sc.device != dev:
            raise ValueError(
                f"megastep: weight {i} must be int8 ({k // 2}, {h}) with "
                f"{h} float32 scales on {dev}, got {q.dtype} "
                f"{tuple(q.shape)} and {sc.dtype} {tuple(sc.shape)}")
        w += [q.contiguous(), sc.reshape(h).contiguous()]
    return w


def megastep(x, s0, u0, h0, s1, u1, h1, beta0, vth0, beta1, vth1,
             wargs: tuple, fcargs: tuple, *, fc_mode: str, input_bits: int,
             precision: str = "int4", nm_n: int = 0, nm_m: int = 0,
             spike: bool = False,
             plan: MegaPlan | None = None) -> tuple[torch.Tensor, ...]:
    """Launch K6 (``spike=False``) or K7 on CUDA tensors, the operands of
    ``ref.megastep_ref``: ``x`` (F, B, D); ``s0``/``s1`` (TS, B, H) spike
    trains (0/1: the kernel keeps them as bits);
    ``u0``/``h0``/``u1``/``h1`` (B, H); ``beta*``/``vth*`` (H,), all
    float32; ``wargs`` at ``precision="int4"`` four (int8 (K/2, H),
    float32 (H,) or (1, H)) pairs, at ``"float"`` four float32 (K, H)
    matrices; ``fcargs`` per ``fc_mode`` (``dense_float``: ``(w_fc,)``
    (H, N) float32, float only; ``nm``: ``nm_n`` of every ``nm_m`` rows, a
    geometry the kernel refuses unless 1 <= n <= m <= 16).  ``plan``: the
    launch's plan (``tile_plans``' rows, cluster and cols), by default
    ``resident_plan``'s.  Returns
    ``(s0, u0, s1, u1, logits (F, B, N), spikes_l0 (F, TS, B), spikes_l1
    (F, TS, B), union_l1 (F, B), input_one_bits (F, B))``, float32."""
    global launches, spike_launches
    f32 = torch.float32
    state = dict(x=x, s0=s0, u0=u0, h0=h0, s1=s1, u1=u1, h1=h1, beta0=beta0,
                 vth0=vth0, beta1=beta1, vth1=vth1)
    dev = _build.cuda_device("megastep", dict.fromkeys(state, f32), **state)
    frames, b, d = x.shape
    ts, _, h = s0.shape
    if frames < 1 or b < 1 or ts < 1 or d % 2 or h % 2 \
            or s1.shape != (ts, b, h) \
            or any(t.shape != (b, h) for t in (u0, h0, u1, h1)) \
            or any(t.numel() != h for t in (beta0, vth0, beta1, vth1)):
        raise ValueError(
            f"megastep: shapes x {tuple(x.shape)}, s0 {tuple(s0.shape)}, s1 "
            f"{tuple(s1.shape)}, u/h "
            f"{[tuple(t.shape) for t in (u0, h0, u1, h1)]} do not agree "
            f"(F, B, TS >= 1; D, H even)")
    ref.check_megastep_modes(precision, fc_mode)
    w = _layer_weights(wargs, precision, d, h, dev)
    fc_a, fc_values, fc_scale, n, nnz = _fc_operands(fc_mode, fcargs, h)
    if any(t is not None and t.device != dev
           for t in (fc_a, fc_values, fc_scale)):
        raise ValueError(f"megastep: FC operands must lie on {dev}")
    x, s0, u0, h0, s1, u1, h1 = (t.contiguous()
                                 for t in (x, s0, u0, h0, s1, u1, h1))
    lif = [t.reshape(h).contiguous() for t in (beta0, vth0, beta1, vth1)]
    outs = (torch.empty((ts, b, h), dtype=f32, device=dev),
            torch.empty((b, h), dtype=f32, device=dev),
            torch.empty((ts, b, h), dtype=f32, device=dev),
            torch.empty((b, h), dtype=f32, device=dev),
            torch.empty((frames, b, n), dtype=f32, device=dev),
            torch.empty((frames, ts, b), dtype=f32, device=dev),
            torch.empty((frames, ts, b), dtype=f32, device=dev),
            torch.empty((frames, b), dtype=f32, device=dev),
            torch.empty((frames, b), dtype=f32, device=dev))
    fn = _build.function("megastep_launch", _ARGS)
    ptr = [None if t is None else t.data_ptr()
           for t in (x, s0, u0, h0, s1, u1, h1, *lif, *w, fc_a, fc_values,
                     fc_scale)]
    with torch.cuda.device(dev):
        if plan is None:
            plan = resident_plan(ts, b, d, h, precision, fc_mode, nnz,
                                 int(nm_n), int(nm_m), bool(spike))
        status = fn(*ptr[:19], PRECISIONS[precision], FC_MODES[fc_mode],
                    *ptr[19:], *(t.data_ptr() for t in outs),
                    frames, ts, b, d, h, n, nnz, int(nm_n), int(nm_m),
                    int(input_bits), int(spike), plan.rows, plan.cluster,
                    plan.cols, _build.stream(dev))
    _build.check(status, "megastep")
    if spike:
        spike_launches += 1
    else:
        launches += 1
    return outs
