"""The RSNN dry-run cells (``launch/rsnn_cells.py``) against the
reference's ``hlo.analyze`` of the same steps on one JAX device.

The reference's train step (``loss_fn``, ``value_and_grad``, AdamW, the
state donated) and serve step (one ``frame_step``, an argmax) are rebuilt
here as its ``launch/rsnn_cells.py`` writes them, which is not imported
(it sets ``XLA_FLAGS`` at import).  Both sides at the cells' full batch
(4,096 utterances, 65,536 streams); the train utterances cut from 100
frames to ``FRAMES`` (the port's trace, not its count, grows with the
frames: a Python loop where the reference scans).  Measured ratios port /
reference (on the CPU, torch 2.13):

  variant      rsnn_train  rsnn_serve
  paper        0.9866      0.9926
  layerwise    0.9921      0.9957
  ts1          0.9960      0.9992
  baseline256  0.9845      0.9942
  paper_dp     0.9866      0.9926
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import hlo as j_hlo
from repro.core import rsnn as j_rsnn
from repro.training import optimizer as j_opt
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, rsnn_cells

RTOL = 0.05  # |port / reference - 1|; measured at most 0.0155 (above)
FRAMES = 10


@pytest.fixture(autouse=True)
def short_utterances(monkeypatch):
    monkeypatch.setattr(rsnn_cells, "FRAMES", FRAMES)
    shd.set_activation_axes(None)
    yield
    shd.set_activation_axes(None)


def reference_cost(kind: str, variant: str) -> dict:
    c = rsnn_cells.RSNN_VARIANTS[variant]
    cfg = j_rsnn.RSNNConfig(hidden_dim=c.hidden_dim, num_ts=c.num_ts,
                            merged_spike=c.merged_spike)
    params = jax.eval_shape(lambda k: j_rsnn.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    if kind == "rsnn_train":
        ocfg = j_opt.OptimizerConfig(name="adamw")
        opt = jax.eval_shape(lambda p: j_opt.init_opt_state(p, ocfg), params)
        batch = {"features": jax.ShapeDtypeStruct(
            (rsnn_cells.TRAIN_BATCH, FRAMES, cfg.input_dim), jnp.float32),
            "labels": jax.ShapeDtypeStruct(
                (rsnn_cells.TRAIN_BATCH, FRAMES), jnp.int32)}

        def train_step(state, batch):
            def loss(p):
                return j_rsnn.loss_fn(p, batch, cfg)[0]
            l, g = jax.value_and_grad(loss)(state["params"])
            np_, no_, m = j_opt.apply_updates(state["params"], g,
                                              state["opt"], ocfg)
            return {"params": np_, "opt": no_}, dict(m, loss=l)

        lowered = jax.jit(train_step, donate_argnums=(0,)).lower(
            {"params": params, "opt": opt}, batch)
    else:
        state = jax.eval_shape(lambda: j_rsnn.init_state(
            cfg, rsnn_cells.SERVE_BATCH, cfg.num_ts))
        x = jax.ShapeDtypeStruct((rsnn_cells.SERVE_BATCH, cfg.input_dim),
                                 jnp.float32)

        def serve_step(params, state, x_t):
            st, (logits, _) = j_rsnn.frame_step(params, state, x_t, cfg)
            return jnp.argmax(logits, -1).astype(jnp.int32), st

        lowered = jax.jit(serve_step, donate_argnums=(1,)).lower(
            params, state, x)
    return j_hlo.analyze(lowered.compile().as_text())


@pytest.mark.parametrize("variant", list(rsnn_cells.RSNN_VARIANTS))
@pytest.mark.parametrize("kind", ["rsnn_train", "rsnn_serve"])
def test_rsnn_flops_against_reference(kind, variant):
    step, args, _ = rsnn_cells.build(kind, variant, torch.device("meta"))
    _, cost, _ = dryrun.trace(step, args)
    ratio = cost.flops / reference_cost(kind, variant)["flops"]
    assert abs(ratio - 1) <= RTOL, (kind, variant, ratio)
