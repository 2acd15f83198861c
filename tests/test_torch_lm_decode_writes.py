"""Token-LM serving in repro_torch against the reference on the CPU, a
part of ``tests/test_torch_lm_serving.py`` (whose helpers and parameters
it uses): ``generate`` decodes into the prompt-sized prefill cache, so
every decode write lands past it and is dropped, in the reference as in
the port (the recurrent states carry no such cache).

The reference's parameters (``PRNGKey(0)``) are carried across with
``params_from_numpy``; float32 at ``reduce_config``.  The caches equal
where a write is dropped."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest
import torch

from test_torch_lm_serving import (_extra, _named, _prompts,  # noqa: F401
                                   _setup, setups)


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v3-671b",
                                  "whisper-base", "zamba2-7b"])
def test_generate_drops_decode_writes(setups, arch):
    """The reference's generate decodes into the prompt-sized prefill
    cache: the write at pos = S is past its end and dropped, on both
    sides; ``pos`` moves, and so do zamba2's Mamba2 states, which hold no
    sequence axis."""
    _, jp, jfwd, tapi, tp = _setup(setups, arch)
    toks = _prompts(2, 8)
    extra = _extra(tapi, 2)
    _, jpre = jfwd(jp, dict(extra, tokens=toks), mode="prefill")
    _, jdec = jfwd(jp, {"tokens": toks[:, :1]}, cache=jpre)
    _, tpre = tapi.forward(tp, {k: torch.from_numpy(v) for k, v in dict(
        extra, tokens=toks).items()}, mode="prefill")
    _, tdec = tapi.forward(tp, {"tokens": torch.from_numpy(toks[:, :1])},
                           cache=tpre)
    seq = ("k", "v", "kv_latent", "k_rope")
    for before, after in ((jpre, jdec), (tpre, tdec)):
        np.testing.assert_array_equal(np.asarray(after.pos), [9, 9])
        kv = list(zip(_named(before, seq), _named(after, seq)))
        assert kv
        for b, a in kv:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
