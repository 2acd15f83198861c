"""The op counter (``analysis/op_cost.py``) against the reference's
``analysis/hlo.py`` ``analyze``: prefill and decode steps of the ten archs.

Both sides take the arch at ``reduce_config``, prefill over 2 x 64 tokens
and decode one token into a 2 x 64 cache.  The port's step is
``launch/dryrun.py`` ``build``'s, traced on ``meta``; the reference's is
rebuilt from ``repro.launch.steps`` and compiled on one JAX device (its
``launch/dryrun.py`` is not imported: it sets ``XLA_FLAGS`` at import),
and ``hlo.analyze`` reads the compiled HLO.  The port counts matmul FLOPs
by ``torch.utils.flop_counter``'s formulas and one FLOP an element of the
elementwise ops; XLA counts the same two terms in its own program, so the
counts agree within ``RTOL`` and not exactly (XLA rewrites and fuses; the
port's elementwise set is ``hlo.py``'s mapped to aten).  Measured ratios
port / reference on this shape (on the CPU, torch 2.13; train in
``test_torch_dryrun_train.py``):

  arch                prefill  decode
  deepseek-v3-671b    0.9909   0.9994
  gemma-7b            0.9846   1.0548
  gemma2-2b           0.9849   1.0234
  internvl2-26b       0.9913   1.0302
  kimi-k2-1t-a32b     0.9909   0.9994
  stablelm-3b         0.9917   1.0608
  whisper-base        0.9845   1.0196
  xlstm-350m          0.9900   0.9886
  yi-6b               0.9913   1.0302
  zamba2-7b           0.9412   0.9587

``hbm_bytes`` is not compared (XLA fuses, the port runs eagerly); it is
held to be at least the bytes of the step's arguments, which an eager
step reads at least once.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import jax
import pytest
import torch

from repro.analysis import hlo as j_hlo
from repro.configs.base import ShapeConfig as JShape
from repro.launch import steps as j_steps
from repro.models import registry as j_registry
from repro.training import optimizer as j_opt
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.models import registry

ARCHS = registry.list_archs()
RTOL = 0.10  # |port / reference - 1|; measured at most 0.061 (above)
SEQ, BATCH = 64, 2


class Reduced:
    """``models.registry`` as ``launch/dryrun.py`` sees it, every arch at
    ``reduce_config``."""

    list_archs = staticmethod(registry.list_archs)

    @staticmethod
    def get_model(arch, cfg=None):
        if cfg is None:
            cfg = registry.reduce_config(registry.get_model(arch).cfg)
        return registry.get_model(arch, cfg)


@pytest.fixture(autouse=True)
def reduced(monkeypatch):
    monkeypatch.setattr(dryrun, "registry", Reduced)
    shd.set_activation_axes(None)
    yield
    shd.set_activation_axes(None)


def reference_cost(arch: str, kind: str, seq: int, batch: int) -> dict:
    """``hlo.analyze`` of the reference's step at ``reduce_config``, built
    as its ``launch/dryrun.py`` ``input_specs`` builds it, compiled for
    one device."""
    cfg = j_registry.reduce_config(j_registry.get_model(arch).cfg)
    api = j_registry.get_model(arch, cfg)
    shape = JShape("small", seq, batch, kind)
    params = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    bshapes = j_steps.batch_shapes(cfg, shape)
    if kind == "train":
        ocfg = j_opt.OptimizerConfig(name=cfg.optimizer)
        opt = jax.eval_shape(lambda p: j_opt.init_opt_state(p, ocfg), params)
        step = jax.jit(j_steps.make_train_step(api, ocfg), donate_argnums=0)
        args = ({"params": params, "opt": opt}, bshapes)
    elif kind == "prefill":
        step = jax.jit(j_steps.make_prefill_step(api))
        args = (params, bshapes)
    else:
        cache = jax.eval_shape(lambda: api.init_cache(batch, seq))
        step = jax.jit(j_steps.make_decode_step(api), donate_argnums=1)
        args = (params, cache, bshapes)
    return j_hlo.analyze(step.lower(*args).compile().as_text())


def port_cost(arch: str, kind: str, seq: int, batch: int,
              dev: str = "meta", variant: str | None = None):
    """The port's step from ``dryrun.build`` (at ``reduce_config``),
    counted once: (counter, the step's arguments)."""
    _, step, args, _ = dryrun.build(arch, ShapeConfig("small", seq, batch,
                                                      kind),
                                    torch.device(dev), variant)
    _, cost, _ = dryrun.trace(step, args)
    return cost, args


def check_against_reference(arch: str, kind: str, seq: int, batch: int):
    want = reference_cost(arch, kind, seq, batch)
    got, args = port_cost(arch, kind, seq, batch)
    ratio = got.flops / want["flops"]
    assert abs(ratio - 1) <= RTOL, (arch, kind, ratio)
    arg_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(args))
    assert got.hbm_bytes >= arg_bytes, (got.hbm_bytes, arg_bytes)
    assert got.ops > 0 and got.peak_bytes > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_flops_against_reference(arch, kind):
    check_against_reference(arch, kind, SEQ, BATCH)
