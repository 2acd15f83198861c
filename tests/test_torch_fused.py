"""repro_torch's mega-step (K6 ``megastep``, K7 ``megastep(spike=True)``)
and its ``fused``/``fused_spike`` backends vs the reference's, on the CPU.

The same seeded numpy inputs go through ``repro.kernels`` (the Pallas
mega-step in interpret mode, and the reference's ``megastep_ref``) and
``repro_torch.kernels`` on CPU tensors (``ref.megastep_ref``, the plain
version the CUDA kernel is held against on the card).  Tolerances:

* spikes and the four counters exact (these seeds put no membrane
  potential within rounding of a threshold);
* ``u`` within ``|d| <= 1e-5 * (1 + |y|)`` (``_close``): float32 sums of
  dequantized weights in another order (and, in spike mode, over the
  event lists);
* logits bit-equal with the CSC readout (integer sums, one scale in both
  packages); with ``dense_int4`` within that tolerance: the reference sums
  dequantized float32 weights where the port sums integers and scales
  once;
* inside the port: the plain K7 equals the plain K6 in spikes, counters
  and logits.

``tests/test_torch_fused_serving.py`` holds the two backends' served
frames, loops and chunk steps, with the helpers of this file.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import ast
import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.layouts import base as layout_base
from repro_torch.core.layouts import csc as t_csc
from repro_torch.core.layouts import dense as t_dense
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import megastep as mega_kernel
from repro_torch.serving import backends
from repro_torch.serving import stream as TS
from test_torch_kernels import c_signature
from test_torch_spike import _close
from test_torch_stream import ROOT, small_path  # noqa: F401

# (input_dim, hidden, fc_dim, batch): small_cfg's widths and PRUNED's
WIDTHS = {"small": (8, 16, 12, 3), "pruned": (40, 128, 1920, 4)}
FUSED = ["fused", "fused_spike"]
STATE = ("s0", "u0", "s1", "u1")
OUTS = STATE + ("logits", "spikes_l0", "spikes_l1", "union_l1",
                "input_one_bits")


def _operands(width: str, ts: int, fc_mode: str, frames: int = 3,
              seed: int = 41) -> tuple:
    """Seeded numpy operands of ``megastep``: 8-bit integer frames,
    random 0/1 trains and LIF carries, int4 layer weights, and the FC as
    dense nibbles or padded CSC."""
    d, h, n, b = WIDTHS[width]
    rng = np.random.default_rng(seed)

    def spikes(*shape):
        return (rng.random(shape) < 0.3).astype(np.float32)

    def scale(m, lo, hi):
        return rng.uniform(lo, hi, (1, m)).astype(np.float32)

    def packed(k, m):
        return rng.integers(-128, 128, (k // 2, m)).astype(np.int8)

    x = np.clip(np.round(rng.normal(size=(frames, b, d)) * 30), -127,
                127).astype(np.float32)
    state = (spikes(ts, b, h), rng.normal(size=(b, h)).astype(np.float32),
             spikes(b, h), spikes(ts, b, h),
             rng.normal(size=(b, h)).astype(np.float32), spikes(b, h))
    lif = tuple(a for _ in range(2) for a in (
        rng.choice([0.5, 0.75, 0.875], h).astype(np.float32),
        np.ones(h, np.float32)))
    wargs = (packed(d, h), scale(h, 0.002, 0.006), packed(h, h),
             scale(h, 0.02, 0.06), packed(h, h), scale(h, 0.1, 0.25),
             packed(h, h), scale(h, 0.02, 0.06))
    if fc_mode == "dense_int4":
        fcargs = (packed(h, n), scale(n, 0.01, 0.1))
    else:
        nnz = max(h // 2, 1)
        idx = np.sort(rng.permuted(np.tile(np.arange(h), (n, 1)), axis=1)
                      [:, :nnz].T, axis=0).astype(np.int32)
        val = rng.integers(-8, 8, (nnz, n)).astype(np.float32)
        val[-2:, ::3] = 0.0  # padded tails: (index 0, value 0)
        idx[-2:, ::3] = 0
        fcargs = (idx, val, scale(n, 0.01, 0.1))
    return (x, *state, *lif, wargs, fcargs)


def _to_jax(args):
    return tuple(tuple(map(jnp.asarray, a)) if isinstance(a, tuple)
                 else jnp.asarray(a) for a in args)


def _to_port(args):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return tuple(tuple(map(t, a)) if isinstance(a, tuple) else t(a)
                 for a in args)


def _assert_outputs(port, want, exact_logits: bool):
    """Nine outputs: spikes and counters exact, u within ``_close``'s
    tolerance, logits exact or within it."""
    for name, p, w in zip(OUTS, port, want):
        p, w = p.numpy(), np.asarray(w)
        assert p.shape == w.shape, name
        if name in ("u0", "u1") or (name == "logits" and not exact_logits):
            _close(p, w)
        else:
            np.testing.assert_array_equal(p, w, err_msg=name)


# ------------------------------------------------------------ megastep_ref


@pytest.mark.parametrize("width,ts", [("small", 1), ("small", 2),
                                      ("pruned", 2)])
@pytest.mark.parametrize("fc_mode", ["dense_int4", "csc"])
@pytest.mark.parametrize("spike", [False, True])
def test_megastep_ref_matches_reference(width, ts, fc_mode, spike):
    """The port's plain K6/K7 over a 3-frame chunk against the
    reference's oracle and its Pallas mega-step in interpret mode (same
    ``spike`` mode); and K7's plain version against K6's."""
    args = _operands(width, ts, fc_mode)
    kw = dict(fc_mode=fc_mode, input_bits=8)
    got = ref.megastep_ref(*_to_port(args), **kw, spike=spike)
    exact = fc_mode == "csc"
    _assert_outputs(got, jref.megastep_ref(*_to_jax(args), precision="int4",
                                           **kw), exact)
    _assert_outputs(got, jops.megastep(*_to_jax(args), precision="int4",
                                       **kw, spike=spike), exact)
    other = ref.megastep_ref(*_to_port(args), **kw, spike=not spike)
    _assert_outputs(got, other, exact_logits=True)
    s1 = got[2].numpy()
    assert 0.05 < float(s1.mean()) < 0.95  # the layers fire, not always
    assert got[4].shape == (3, WIDTHS[width][3], WIDTHS[width][2])


def test_megastep_ref_refuses_other_fc_modes():
    """An FC mode no layout binds is refused by the plain version, the
    dispatch and the wrapper's operand check (``nm`` is served,
    ``tests/test_torch_nm.py``; ``dense_float`` with float weights,
    ``tests/test_torch_float.py``)."""
    args = _to_port(_operands("small", 2, "dense_int4"))
    with pytest.raises(ValueError, match="fc_mode"):
        ref.megastep_ref(*args, fc_mode="bogus", input_bits=8)
    with pytest.raises(ValueError, match="fc_mode"):
        ops.megastep(*args, fc_mode="sparse", input_bits=8)
    with pytest.raises(ValueError, match="fc_mode"):
        mega_kernel._fc_operands("bogus", args[-1], 16)


def test_cpu_tensor_runs_plain_version_without_launching():
    before = (mega_kernel.launches, mega_kernel.spike_launches)
    args = _to_port(_operands("small", 2, "csc"))
    for spike in (False, True):
        out = ops.megastep(*args, fc_mode="csc", input_bits=8, spike=spike)
        assert len(out) == 9
    assert (mega_kernel.launches, mega_kernel.spike_launches) == before
    assert _build._lib is None  # nothing was built
    with pytest.raises(ValueError, match="CUDA"):
        mega_kernel.megastep(*args, fc_mode="csc", input_bits=8)


# ------------------------------------------------------- K6/K7 tile plans

# (width, FC mode at its precision, entries a column): PRUNED's int4 FCs
# (the served CSC's 95 entries, 2:4 N:M's 64) and BASELINE's float FC
MEGA_SERVED = [("pruned", "dense_int4", 0), ("pruned", "csc", 95),
               ("pruned", "nm", 64), ("baseline", "dense_float", 0)]
MEGA_DIMS = {"pruned": (40, 128), "baseline": (40, 256)}  # (D, H)


@pytest.mark.parametrize("width,fc_mode,entries", MEGA_SERVED)
@pytest.mark.parametrize("ts", [1, 2, 4])
@pytest.mark.parametrize("b", [256, 200, 1])
@pytest.mark.parametrize("spike", [False, True])
def test_megastep_tile_plans_fit(width, fc_mode, entries, ts, b, spike):
    """Every K6/K7 plan at these shapes: 32 slots, clusters of 16 or 8,
    16-128 FC columns a sub-tile, ceil(B / 32) clusters; ``tile_plan``
    picks one whose CTA fits 227 KB of shared memory, the larger cluster
    first."""
    d, h = MEGA_DIMS[width]
    plans = mega_kernel.tile_plans(ts, b, d, h, fc_mode, entries, spike)
    for p in plans:
        assert p.rows == 32 and p.cluster in (8, 16)
        assert p.cols in (16, 32, 64, 128)
        assert p.ctas == -(-b // 32) * p.cluster
    plan = mega_kernel.tile_plan(ts, b, d, h, fc_mode, entries, spike)
    assert plan in plans
    assert plan.shared_bytes <= _build.MAX_SHARED_BYTES
    fits = [p for p in plans if p.shared_bytes <= _build.MAX_SHARED_BYTES]
    assert plan == fits[0] and plan.cluster == max(p.cluster for p in fits)


@pytest.mark.parametrize("width,fc_mode,entries", MEGA_SERVED)
@pytest.mark.parametrize("spike", [False, True])
def test_megastep_tile_plan_fills_the_card(width, fc_mode, entries, spike):
    """At the served shape (B = 256, TS = 2) the plan's grid has at least
    64 CTAs (eight clusters of 8 or 16): the old kernel's 32 blocks were
    a quarter of the 132 SMs."""
    d, h = MEGA_DIMS[width]
    plan = mega_kernel.tile_plan(2, 256, d, h, fc_mode, entries, spike)
    assert plan.ctas >= 64 and plan.cluster > 1


def test_megastep_shared_bytes_grow_with_the_shape():
    """The CTA's shared memory as ``MegaLayout`` lays it out: K7 adds its
    event lists, a wider hidden layer its slices and trains, more entries
    their FC tiles; the float slices at BASELINE over 16 CTAs are 51.7 KB
    (808 rows x 16 columns x 4 B)."""
    k6 = mega_kernel.shared_bytes(2, 40, 128, "csc", 95, False, 16, 64)
    assert mega_kernel.shared_bytes(2, 40, 128, "csc", 95, True, 16,
                                    64) > k6
    assert mega_kernel.shared_bytes(2, 40, 128, "csc", 96, False, 16,
                                    64) > k6
    assert mega_kernel.shared_bytes(2, 40, 256, "csc", 95, False, 16,
                                    64) > k6
    assert mega_kernel.shared_bytes(4, 40, 128, "csc", 95, False, 16,
                                    64) > k6
    f32 = mega_kernel.shared_bytes(2, 40, 256, "dense_float", 0, False, 16,
                                   32)
    assert f32 - mega_kernel.shared_bytes(2, 40, 256, "dense_float", 0,
                                          False, 16, 16) == 2 * 4 * 256 * 16
    assert 808 * 16 * 4 == 51712 < f32


# (h, fc_mode, entries, spike): PRUNED csc K6, BASELINE float K6 and K7
_CSC = (128, "csc", 95, False)
_F32 = (256, "dense_float", 0, False)
_F32_K7 = (256, "dense_float", 0, True)


@pytest.mark.parametrize("shape,held16,held8,want", [
    (_CSC, 8, 16, (16, 128)), (_CSC, 7, 16, (8, 128)),
    (_CSC, 0, 16, (8, 128)), (_F32, 7, 15, (8, 32)),
    (_F32, 7, 7, (16, 32)), (_F32, 1, 1, (16, 32)),
    (_F32_K7, 7, 15, (16, 32))])
def test_megastep_resident_plan_takes_one_wave(monkeypatch, shape, held16,
                                               held8, want):
    """On the card the plan is, among those that fit, the widest sub-tile
    (128 columns at PRUNED, 32 at BASELINE float), then the fewest waves
    of its eight clusters (B = 256) over those the card holds at once
    (``held16``, ``held8``), then the larger cluster.  At BASELINE float
    only clusters of 16 fit K7's 32-column sub-tile: they stay the plan
    over two waves rather than give way to 16 columns in one."""
    def info(plan, *shape):
        return plan.shared_bytes, held16 if plan.cluster == 16 else held8

    h, fc_mode, entries, spike = shape
    precision = "float" if fc_mode == "dense_float" else "int4"
    monkeypatch.setattr(mega_kernel, "plan_info", info)
    monkeypatch.setattr(mega_kernel, "_resident", {})
    plan = mega_kernel.resident_plan(2, 256, 40, h, precision, fc_mode,
                                     entries, 0, 0, spike)
    assert (plan.cluster, plan.cols) == want
    assert plan.shared_bytes <= _build.MAX_SHARED_BYTES


@pytest.mark.parametrize("name,args", [
    ("megastep_launch", mega_kernel._ARGS),
    ("megastep_plan_info", mega_kernel._INFO_ARGS)])
def test_megastep_signatures_match_the_kernel_source(name, args):
    """The wrapper's ctypes lists against ``csrc/megastep.cu``'s C
    signatures (a mismatch would pass a pointer as an int)."""
    assert c_signature("megastep.cu", name) == args


def test_megastep_trace_names_every_stamp():
    """``megastep_trace.py`` builds ``megastep.cu`` with its stamps on and
    names the phase each ``MEGA_STAMP(i)`` ends: the source holds stamps
    0 .. len(PHASES) - 1, each once, and a build without the macro none."""
    src = (ROOT / "src/repro_torch/csrc/megastep.cu").read_text()
    stamps = [int(i) for i in re.findall(r"MEGA_STAMP\((\d+)\);", src)]
    tree = ast.parse((ROOT / "megastep_trace.py").read_text())
    phases = next(ast.literal_eval(node.value) for node in tree.body
                  if isinstance(node, ast.Assign)
                  and node.targets[0].id == "PHASES")
    assert sorted(stamps) == list(range(len(phases)))
    assert "#define MEGA_STAMP(i) do { } while (0)" in src


# ----------------------------------------------------------- served frames


# ---------------------------------------------------------- table contract


@pytest.mark.parametrize("backend", FUSED)
def test_collapsed_entries_raise(small_path, backend):
    port = TS.CompiledRSNN.from_artifact(small_path, backend=backend,
                                         device="cpu")
    for op in ("rsnn_cell", "ff_matmul", "fc"):
        with pytest.raises(RuntimeError, match="one megastep launch"):
            getattr(port.ops, op)()
    assert port.ops.delta_gate is None


@pytest.mark.parametrize("backend", FUSED)
def test_fused_without_merged_spike_raises(small_path, backend):
    port = TS.CompiledRSNN.from_artifact(small_path, backend="pallas",
                                         device="cpu")
    ctx = dataclasses.replace(port._ctx, cfg=dataclasses.replace(
        port.cfg, merged_spike=False))
    with pytest.raises(ValueError, match="merged-spike"):
        backends.resolve(backend, ctx)
    backends.resolve("pallas", ctx)  # a per-ts readout backend serves it


def test_layout_megastep_fc_bindings(small_path):
    port = TS.CompiledRSNN.from_artifact(small_path, backend="pallas",
                                         device="cpu")
    qt, sc = port.packed.quant["fc_w"], port.packed.sparse["fc_w"]
    mode, operands, statics = t_dense.DENSE.megastep_fc(qt)
    assert (mode, statics) == ("dense_int4", {})
    assert operands[0] is qt.packed and operands[1] is qt.scale
    mode, operands, statics = t_csc.CSC.megastep_fc(sc)
    assert (mode, statics) == ("csc", {})
    assert all(a is b for a, b in zip(operands,
                                      (sc.indices, sc.values, sc.scale)))

    class Bare(layout_base.WeightLayout):
        name, tensor_type = "bare", tuple
        matmul = fc_kernel = unflatten = None
        pack = unpack = stored_entries = size_bytes = flatten = None

    with pytest.raises(NotImplementedError, match="mega-step"):
        Bare().megastep_fc(())


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, repro_torch.kernels.megastep, "
            "repro_torch.serving.backends; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
