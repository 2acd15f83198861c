"""Token-LM serving in repro_torch against the reference on the CPU, a
part of ``tests/test_torch_lm_serving.py`` (whose helpers and parameters
it uses): ``ServeLoop``'s finishing order and outputs equal to the
reference's (whisper, which it passes no frames, raising in both).
``tests/test_torch_lm_decode_writes.py`` holds ``generate``'s dropped
decode writes.

The reference's parameters (``PRNGKey(0)``) are carried across with
``params_from_numpy``; float32 at ``reduce_config``.  Token ids exact."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest

from repro.serving import engine as j_engine
from repro_torch.serving.engine import SamplerConfig, ServeLoop
from test_torch_lm_serving import _prompts, _setup, setups  # noqa: F401


def _serve(loop_cls, api, params, scfg, requests):
    loop = loop_cls(api, params, batch_slots=2, scfg=scfg)
    for prompt, max_new in requests:
        loop.submit(prompt, max_new)
    return [(r.rid, [int(t) for t in r.out], r.done) for r in loop.run()]


@pytest.mark.parametrize("arch,n", [("gemma2-2b", 5), ("xlstm-350m", 3),
                                    ("zamba2-7b", 3)])
def test_serve_loop_matches_reference(setups, arch, n):
    """``n`` requests over 2 slots (a slot refilled at least once), prompts
    of 3-8 tokens and 2-5 new tokens, then again with an EOS id that cuts
    an output short.  The reference compiles its steps anew for every
    prompt width, so the recurrent archs take 3 requests, not 5."""
    japi, jp, _, tapi, tp = _setup(setups, arch)
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, 503, size=rng.integers(3, 9)),
                 int(rng.integers(2, 6))) for _ in range(n)]
    want = _serve(j_engine.ServeLoop, japi, jp, j_engine.SamplerConfig(),
                  requests)
    got = _serve(ServeLoop, tapi, tp, SamplerConfig(), requests)
    assert got == want
    assert [len(out) for _, out, _ in got] == [m for _, m in requests]
    eos = got[0][1][1]
    want = _serve(j_engine.ServeLoop, japi, jp,
                  j_engine.SamplerConfig(eos_id=eos), requests)
    got = _serve(ServeLoop, tapi, tp, SamplerConfig(eos_id=eos), requests)
    assert got == want
    assert len(got[0][1]) == 2 and got[0][1][-1] == eos


def test_serve_loop_whisper_needs_frames(setups):
    """``ServeLoop`` calls ``generate`` with no frames, so whisper's
    prefill has nothing to encode, in the reference as in the port."""
    japi, jp, _, tapi, tp = _setup(setups, "whisper-base")
    for loop_cls, api, params, scfg in (
            (j_engine.ServeLoop, japi, jp, j_engine.SamplerConfig()),
            (ServeLoop, tapi, tp, SamplerConfig())):
        with pytest.raises(AttributeError):
            _serve(loop_cls, api, params, scfg, [(_prompts(1, 4)[0], 2)])
