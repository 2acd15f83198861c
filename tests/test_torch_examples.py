"""The port's quickstart example against the reference's, on the CPU.

``examples/quickstart_torch.py`` runs from the reference's initial
parameters (``rsnn.init_params(PRNGKey(0))``, carried across as numpy):
its losses and frame error rates over the first ``EXACT_STEPS`` steps
within ``STEP_RTOL`` of the reference example's (the two sides sum in
different orders), at the printed steps 10 and 20 within ``LOSS_RTOL`` and
``FER_ATOL`` (from step 3 on, a weight that the two sides' float32 sums
put on either side of an int4 rounding boundary, or a potential on either
side of a threshold, sends the trajectories apart: over 30 steps the
losses differ by up to 3.4e-3 of their size and the error rates by up to
11 of the 800 frames), its Fig. 12/13/17 accounting equal, and its
kernel section (K1 ``rsnn_cell``, K3 ``merged_spike_fc``) on the
reference's trained weights held to the reference's Pallas kernels at
``tests/test_torch_kernels.py``'s tolerances: a spike may differ only
where the potential lies within ``U_TOL`` of the threshold, the other
potentials within ``U_TOL``, and the logits of every row whose spikes
agree within ``FP32_TOL``.

Both examples default to the card and raise without it, and import
neither JAX nor the reference.  ``tests/test_torch_examples_compress.py``
holds the compression example's numbers.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import complexity as j_C
from repro.core import lif as j_lif
from repro.core import rsnn as j_rsnn
from repro.core.compression import (CompressionConfig as JCompressionConfig,
                                    compressed_size_bytes as j_size,
                                    init_compression as j_init_compression,
                                    materializer as j_materializer,
                                    quantization as j_quant)
from repro.data.synthetic import SpeechDataConfig, TimitLikeStream
from repro.kernels import ops as j_ops
from repro.training import optimizer as j_opt
from repro.training.rsnn_pipeline import make_train_step as j_make_step
from repro_torch.core import artifact
from repro_torch.core.compression import CompressionState
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
U_TOL = 1e-5  # tests/test_torch_kernels.py: K1's |du| <= U_TOL (1 + |u|)
FP32_TOL = 1e-5  # tests/test_torch_kernels.py: |d| <= FP32_TOL (1 + |y|)
EXACT_STEPS, STEP_RTOL = 3, 1e-5  # before the trajectories part
LOSS_RTOL, FER_ATOL = 1e-2, 0.02  # steps 10 and 20: 16 frames of 800


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------ quickstart


def _flat(params) -> dict:
    """The reference's RSNN parameters as ``params_from_arrays``'s flat
    dict of numpy arrays."""
    flat = {}
    for n, v in params.items():
        if isinstance(v, j_lif.LIFParams):
            for f in v._fields:
                flat[f"params['{n}'].{f}"] = np.asarray(getattr(v, f))
        else:
            flat[f"params['{n}']"] = np.asarray(v)
    return flat


def _reference_quickstart(steps: int):
    """``examples/quickstart.py``'s training and accounting, the losses
    and frame error rates of every step kept.  Returns (initial
    parameters as numpy, trained parameters, cstate, history,
    accounting)."""
    cfg = j_rsnn.RSNNConfig(hidden_dim=128, num_ts=2)
    stream = TimitLikeStream(SpeechDataConfig(frames=50))
    params = j_rsnn.init_params(jax.random.PRNGKey(0), cfg)
    flat0 = _flat(params)
    ccfg = JCompressionConfig(fc_prune_frac=0.4, weight_bits=4)
    cstate = j_init_compression(params, ccfg)
    ocfg = j_opt.OptimizerConfig(lr=3.5e-3, warmup_steps=5, decay_steps=50,
                                 weight_decay=0.0)
    state = {"params": params, "opt": j_opt.init_opt_state(params, ocfg)}
    step = jax.jit(j_make_step(cfg, ocfg, ccfg, cstate, num_ts=2),
                   donate_argnums=(0,))
    history = []
    for i in range(steps):
        b = stream.batch(16, step=i)
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        history.append((float(m["loss"]), float(m["frame_error_rate"])))
    sp = j_C.SparsityProfile()
    acc = {"size_kb": j_size(state["params"], ccfg, cstate) / 1e3,
           "mmac": j_C.mmac_per_second(cfg, 2, sparsity=sp,
                                       merged_spike=True),
           "cycles": j_C.cycles_per_frame(cfg, 2, sparsity=sp,
                                          merged_spike=True)}
    return flat0, state["params"], ccfg, cstate, history, acc


def _reference_kernels(params, ccfg, cstate):
    """The reference example's kernel section, its inputs drawn as the
    port's are."""
    eff = j_materializer(ccfg, cstate)(params)
    rng = np.random.default_rng(0)
    s_prev = jnp.asarray(rng.integers(0, 2, (2, 128, 128)), jnp.float32)
    stim = jnp.asarray(rng.normal(size=(2, 128, 128)), jnp.float32)
    z = jnp.zeros((128, 128))
    spikes, u = j_ops.rsnn_cell(stim, s_prev, eff["l0_wh"], z, z,
                                j_lif.beta_of(params["lif0"]),
                                j_lif.vth_of(params["lif0"]))
    qw, scale = j_quant.quantize_to_int(eff["fc_w"])
    logits = j_ops.merged_spike_fc(spikes, j_quant.pack_int4(qw), scale[0])
    return np.asarray(spikes), np.asarray(u), np.asarray(logits)


def _near_threshold(stim, s_prev, w, beta, vth):
    """(B, H) elements whose potential comes within ``U_TOL`` of the
    threshold at some time step (the chain replayed in float64 from
    u0 = h0 = 0)."""
    u = np.zeros(s_prev.shape[1:])
    h = np.zeros(s_prev.shape[1:])
    near = np.zeros(s_prev.shape[1:], bool)
    for t in range(s_prev.shape[0]):
        u = stim[t] + s_prev[t] @ w + beta * u * (1.0 - h)
        near |= np.abs(u - vth) <= U_TOL * (1.0 + np.abs(u))
        h = (u >= vth).astype(np.float64)
    return near


def test_quickstart_matches_reference(monkeypatch, capsys):
    flat0, j_params, j_ccfg, j_cstate, j_hist, j_acc = \
        _reference_quickstart(30)
    example = _example("quickstart_torch")
    monkeypatch.setattr(example.rsnn, "init_params",
                        lambda gen, cfg: artifact.params_from_arrays(flat0,
                                                                     cfg))
    runs = []
    real_run = example.run
    monkeypatch.setattr(example, "run",
                        lambda device: runs.append(real_run(device)))
    before = ops.launch_counts()
    assert example.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    (got,) = runs
    # the reference example's lines, the kernel header aside
    assert re.findall(r"step (\d+): loss=", out) == ["0", "10", "20"]
    for line in ("== training (QAT int4 + pruned, 2 time steps) ==",
                 "== compression accounting (paper Fig. 12) ==",
                 f"  deployed size: {j_acc['size_kb']:.1f} KB",
                 f"  complexity 2ts merged: {j_acc['mmac']:.2f} MMAC/s",
                 f"  cycles/frame: {j_acc['cycles']:.0f} (paper: 895",
                 "  rsnn_cell: spikes (2, 128, 128), rate ",
                 "  merged_spike_fc (int4): logits (128, 1920), "
                 "finite=True"):
        assert line in out, line
    np.testing.assert_allclose(got["history"][:EXACT_STEPS],
                               j_hist[:EXACT_STEPS], rtol=STEP_RTOL)
    for i in (10, 20):
        np.testing.assert_allclose(got["history"][i][0], j_hist[i][0],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["history"][i][1], j_hist[i][1],
                                   rtol=0, atol=FER_ATOL)
    assert got["history"][29][0] < got["history"][0][0]
    assert got["accounting"] == j_acc

    # the kernel section on the reference's trained weights and masks
    flat = _flat(j_params)
    t_params = artifact.params_from_arrays(flat, example.CFG)
    t_cstate = CompressionState(masks={
        n: torch.from_numpy(np.asarray(m)) for n, m in
        j_cstate.masks.items()})
    k = example.kernels(t_params, t_cstate)
    assert ops.launch_counts() == before  # CPU tensors: plain versions
    sp_j, u_j, lg_j = _reference_kernels(j_params, j_ccfg, j_cstate)
    stim, s_prev, w, _, _, beta, vth = (a.numpy().astype(np.float64)
                                        for a in k["cell_args"])
    near = _near_threshold(stim, s_prev, w, beta, vth)
    flipped = (k["spikes"].numpy() != sp_j).any(axis=0)
    assert not (flipped & ~near).any()
    ok = ~(flipped | near)
    np.testing.assert_allclose(k["u"].numpy()[ok], u_j[ok], rtol=U_TOL,
                               atol=U_TOL)
    rows = ~flipped.any(axis=1)
    lg = k["logits"].numpy()
    assert np.all(np.abs(lg[rows] - lg_j[rows])
                  <= FP32_TOL * (1.0 + np.abs(lg_j[rows])))


def test_examples_default_to_cuda_and_raise_without_it(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, argv in (("quickstart_torch", []),
                       ("compress_pipeline_torch", ["--arch", "yi-6b"])):
        with pytest.raises(RuntimeError, match="is_available"):
            _example(name).main(argv)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", ["quickstart_torch",
                                  "compress_pipeline_torch"])
def test_example_imports_leave_jax_and_reference_out(name):
    code = ("import sys, importlib.util as u; "
            f"s = u.spec_from_file_location('e', "
            f"{str(ROOT / 'examples' / f'{name}.py')!r}); "
            "m = u.module_from_spec(s); s.loader.exec_module(m); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
