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
same inputs.  ``launches``
counts K6's launches of this process, ``spike_launches`` K7's.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

launches = 0  # K6 megastep(spike=False)
spike_launches = 0  # K7 megastep(spike=True)

# the kernel's codes: FC modes, and precisions of the layer weights
FC_MODES = {"dense_int4": 0, "csc": 1, "nm": 2, "dense_float": 3}
PRECISIONS = {"int4": 0, "float": 1}
# megastep_launch's C signature: 19 state/weight pointers, precision,
# fc_mode, 3 FC and 9 output pointers, then frames, ts, b, d, h, fc, nnz,
# nm_n, nm_m, input_bits, spike, and the stream
_ARGS = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 12
         + [ctypes.c_int] * 11 + [ctypes.c_void_p])


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
             spike: bool = False) -> tuple[torch.Tensor, ...]:
    """Launch K6 (``spike=False``) or K7 on CUDA tensors, the operands of
    ``ref.megastep_ref``: ``x`` (F, B, D); ``s0``/``s1`` (TS, B, H);
    ``u0``/``h0``/``u1``/``h1`` (B, H); ``beta*``/``vth*`` (H,), all
    float32; ``wargs`` at ``precision="int4"`` four (int8 (K/2, H),
    float32 (H,) or (1, H)) pairs, at ``"float"`` four float32 (K, H)
    matrices; ``fcargs`` per ``fc_mode`` (``dense_float``: ``(w_fc,)``
    (H, N) float32, float only; ``nm``: ``nm_n`` of every ``nm_m`` rows, a
    geometry the kernel refuses unless 1 <= n <= m <= 16).  Returns
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
        status = fn(*ptr[:19], PRECISIONS[precision], FC_MODES[fc_mode],
                    *ptr[19:], *(t.data_ptr() for t in outs),
                    frames, ts, b, d, h, n, nnz, int(nm_n), int(nm_m),
                    int(input_bits), int(spike), _build.stream(dev))
    _build.check(status, "megastep")
    if spike:
        spike_launches += 1
    else:
        launches += 1
    return outs
