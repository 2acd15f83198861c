"""The port's LM yardstick (``analysis/model_flops.py``) and config
variants (``launch/variants.py``) against the reference's.

Every number is an integer count or a product of one with integers, so
``param_counts``, ``model_flops`` and ``model_bytes_decode`` must equal
the reference's exactly, for the ten archs and every shape of
``LM_SHAPES``; ``variants.apply`` must give the reference's config field
for field (``dtype`` compared by name, ``weight_bits`` left out). The port
counts on the ``meta`` device and allocates nothing.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.analysis import model_flops as j_mf
from repro.launch import variants as j_var
from repro_torch import configs
from repro_torch.configs import base as configs_base
from repro_torch.analysis import model_flops as mf
from repro_torch.core.tree import tree_leaves, tree_leaves_with_path
from repro_torch.launch import variants
from repro_torch.models import registry

ROOT = Path(__file__).resolve().parents[1]
ARCHS = registry.list_archs()
PAIR = "ragged_moe+chunked64"  # a "+"-joined variant: both transforms


def test_arch_list_equals_reference():
    from repro.models import registry as j_registry

    assert ARCHS == j_registry.list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch):
    assert mf.param_counts(arch) == j_mf.param_counts(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_bytes_equal_reference(arch):
    for shape, j_shape in zip(configs.LM_SHAPES, j_configs.LM_SHAPES,
                              strict=True):
        assert shape.name == j_shape.name
        assert mf.model_flops(arch, shape) == j_mf.model_flops(arch, j_shape)
        assert mf.model_bytes_decode(arch, shape) == \
            j_mf.model_bytes_decode(arch, j_shape)


def test_reference_accounting_cases():
    """``tests/test_analysis.py``'s two cases, on the port."""
    pc = mf.param_counts("gemma2-2b")
    assert 2.2e9 < pc["total"] < 3.3e9
    assert mf.model_flops("gemma2-2b", configs_base.TRAIN_4K) == \
        pytest.approx(6 * pc["active"] * 256 * 4096, rel=1e-6)
    assert mf.model_flops("gemma2-2b", configs_base.DECODE_32K) == \
        pytest.approx(2 * pc["active"] * 128, rel=1e-6)
    pc = mf.param_counts("deepseek-v3-671b")
    assert 2.5e10 < pc["active"] < 5.5e10
    assert pc["routed"] > 0.9 * pc["total"] * 0.9 or pc["routed"] > 5e11


def test_param_counts_allocate_nothing(monkeypatch):
    """Every ``init`` that ``param_counts`` makes is on the meta device,
    and so is every leaf it returns."""
    real = registry.get_model
    seen = []

    def spy(arch, cfg=None):
        api = real(arch, cfg)

        def init(generator, device="cuda", **kw):
            params = api.init(generator, device=device, **kw)
            seen.append((device, {t.device.type
                                  for t in tree_leaves(params)}))
            return params

        return api._replace(init=init)

    monkeypatch.setattr(mf.registry, "get_model", spy)
    mf.param_counts.cache_clear()
    try:
        counts = {arch: mf.param_counts(arch) for arch in ARCHS}
    finally:
        mf.param_counts.cache_clear()
    assert seen == [("meta", {"meta"})] * len(ARCHS)
    assert counts["kimi-k2-1t-a32b"]["total"] == 1_026_408_209_408


def test_leaf_paths_are_the_reference_keystrs():
    """``tree_leaves_with_path`` writes ``jax.tree_util.keystr``'s paths:
    dict keys, list and tuple indices, NamedTuple fields, ``None``
    empty."""
    import jax

    from repro.core import lif as j_lif
    from repro_torch.core import lif

    t = torch.zeros(1)
    tree = {"b": [t, (t, None)], "a": lif.LIFParams(t, t)}
    j_tree = {"b": [0, (0, None)], "a": j_lif.LIFParams(0, 0)}
    want = sorted(jax.tree_util.keystr(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(j_tree)[0])
    got = [p for p, _ in tree_leaves_with_path(tree)]
    assert got == ["['b'][0]", "['b'][1][0]", "['a'].raw_beta",
                   "['a'].raw_vth"]
    assert sorted(got) == want


def _fields(cfg) -> dict:
    """``cfg`` as a dict, its ``dtype`` as a numpy name, without
    ``weight_bits``: the one field the port's ``ModelConfig`` leaves out
    (``tests/test_torch_lm.py``), which no variant touches."""
    d = dataclasses.asdict(cfg)
    dt = d["dtype"]
    d["dtype"] = (str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype)
                  else np.dtype(dt).name)
    d.pop("weight_bits", None)
    return d


@pytest.mark.parametrize("variant", [None, "", *j_var.VARIANTS, PAIR])
def test_variants_equal_reference(variant):
    assert sorted(variants.VARIANTS) == sorted(j_var.VARIANTS)
    for arch in ARCHS:
        got = variants.apply(configs.ALL_ARCHS[arch], variant)
        want = j_var.apply(j_configs.ALL_ARCHS[arch], variant)
        assert _fields(got) == _fields(want), (arch, variant)


def test_variants_change_what_they_name():
    zamba = variants.apply(configs.ALL_ARCHS["zamba2-7b"],
                           "baseline_seqscan+no_remat")
    assert (zamba.ssm.scan_impl, zamba.remat) == ("sequential", "none")
    ds = variants.apply(configs.ALL_ARCHS["deepseek-v3-671b"], PAIR)
    assert (ds.moe.router_impl, ds.ssm) == ("ragged", None)
    with pytest.raises(KeyError):
        variants.apply(configs.ALL_ARCHS["yi-6b"], "no_such_variant")


@pytest.mark.parametrize("module", ["repro_torch.analysis.model_flops",
                                    "repro_torch.launch.variants"])
def test_imports_leave_jax_and_reference_out(module):
    code = (f"import sys, {module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
