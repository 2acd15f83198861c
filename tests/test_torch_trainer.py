"""The token-LM train step and the fault-tolerant trainer of repro_torch
against the reference on the CPU: ``launch/steps.py`` ``make_train_step``
one step per optimizer against the reference's (parameters, dequantized
optimizer state, metrics) and its in-place ``donate=True`` form bit-equal
to the functional one; ``make_prefill_step`` / ``make_decode_step``;
``tests/test_training.py``'s trainer and fault-tolerance cases on the
port's ``training/trainer.py``, ``runtime/fault_tolerance.py`` and
``data/pipeline.py``; a reduced LM preempted and resumed; a reference
``Trainer``'s checkpoint resumed by the port's; bfloat16 checkpoints
across the packages; ``launch/train.py`` and ``examples/serve_lm_torch.py``
on the CPU, and their default device.

float32 throughout.  A step: the loss and grad norm within ``RTOL`` of
the reference's, a float state leaf within ``STATE_TOL`` of its largest
magnitude (the gradients agree within ~4e-6 of a leaf's largest), an
int8 optimizer code at most one step from the reference's (a value near a
rounding boundary), a parameter within ``ATOL_LR`` x lr of the
reference's except where a code moved.  The first step of AdamW (and of
8-bit AdamW, and Adafactor's unfactored leaves) moves a parameter by lr
g / (|g| + eps): where the clipped |g| is within ``G_FLOOR`` = 1e3 eps of
zero, the gradients' deviation moves that update by up to its whole
size, so those elements (3.5% here) are counted and held only within
(2 + ``ATOL_LR``) x lr.
Resumed runs end within rel 1e-4 of the uninterrupted run's loss, as
``tests/test_training.py`` asks of the reference."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import functools
import importlib.util
import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.data.synthetic import LMDataConfig as JLMDataConfig
from repro.data.synthetic import MarkovLMStream as JMarkovLMStream
from repro.launch import steps as j_steps
from repro.models import registry as j_registry
from repro.serving.cache_utils import pad_cache as j_pad_cache
from repro.training import optimizer as j_opt
from repro.training.trainer import Trainer as JTrainer
from repro.training.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import PrefetchIterator
from repro_torch.data.synthetic import LMDataConfig, MarkovLMStream
from repro_torch.launch import steps
from repro_torch.models import registry
from repro_torch.runtime.fault_tolerance import (Heartbeat, PreemptionHandler,
                                                 StragglerMonitor)
from repro_torch.serving.cache_utils import pad_cache
from repro_torch.training import optimizer as opt
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
ATOL_LR = 0.05  # a parameter's deviation from the reference's, in lr
STATE_TOL = 1e-4  # a float state leaf's, of its largest magnitude
G_FLOOR = 1e-5  # 1e3 x eps: below it g / (|g| + eps) is not compared
ARCH = "gemma2-2b"
B, S = 2, 16


def _cfgs(arch=ARCH):
    return (j_registry.reduce_config(j_registry.get_model(arch).cfg),
            registry.reduce_config(registry.get_model(arch).cfg))


def _numpy_params(arch=ARCH, seed=0):
    """The port's seeded init as numpy leaves, dicts in sorted key order
    (the order of ``jax.tree.leaves``)."""
    _, tc = _cfgs(arch)
    p = registry.get_model(arch, tc).init(torch.Generator().manual_seed(seed),
                                          device="cpu")
    return jax.tree.map(np.asarray, registry.params_to_numpy(p))


def _tokens(vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _codes(tree) -> list:
    """The state's leaves, an int8 codec split into its q and scale."""
    return [x for leaf in opt.tree_leaves(tree)
            for x in (leaf.values() if isinstance(leaf, dict) else [leaf])]


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_grads() -> list:
    """The reference's gradient leaves of the reduced gemma2 loss on
    ``_tokens``: which elements lie near zero."""
    jc, _ = _cfgs()
    api = j_registry.get_model(ARCH, jc)
    toks = jnp.asarray(_tokens(jc.vocab_size))

    def loss_fn(p):
        logits, _ = api.forward(p, {"tokens": toks}, mode="train")
        return j_steps.ce_next_token_loss(logits, toks)

    grads = jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray,
                                                    _numpy_params()))
    return [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor"])
def test_train_step_matches_reference(name):
    """One step from the same parameters and batch: metrics within
    ``RTOL``; float state leaves within ``STATE_TOL`` of their largest;
    int8 codes (the dequantized state) at most one step from the
    reference's, at under 1e-3 of the entries; parameters within
    ``ATOL_LR`` x lr except where a code moved.  Elements whose clipped
    reference gradient lies below ``G_FLOOR`` are not held to that bound
    (see the module docstring); they are counted.  Those and the ones
    whose code moved are held within (2 + ``ATOL_LR``) x lr, as chip_smoke
    phase 8f holds the card's (a first step moves an element by about lr
    at most, a code one step away by 0.28 lr here)."""
    jc, tc = _cfgs()
    kw = {"name": name, "lr": 1e-3, "warmup_steps": 0, "decay_steps": 10}
    jo, to = j_opt.OptimizerConfig(**kw), OptimizerConfig(**kw)
    params = _numpy_params()
    jp = jax.tree.map(jnp.asarray, params)
    toks = _tokens(jc.vocab_size)
    sj, mj = jax.jit(j_steps.make_train_step(j_registry.get_model(ARCH, jc),
                                             jo))(
        {"params": jp, "opt": j_opt.init_opt_state(jp, jo)},
        {"tokens": jnp.asarray(toks)})
    api = registry.get_model(ARCH, tc)
    tp = registry.params_from_numpy(params, "cpu")
    st, mt = steps.make_train_step(api, to)(
        {"params": tp, "opt": opt.init_opt_state(tp, to)},
        {"tokens": torch.from_numpy(toks)})
    assert sorted(mt) == sorted(mj) == ["grad_norm", "loss", "lr"]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=RTOL)
    lr = float(mj["lr"])
    clip = min(1.0, jo.grad_clip / float(mj["grad_norm"]))
    near_zero = [np.abs(g) * clip < G_FLOOR for g in _reference_grads()]
    n_entries = sum(z.size for z in near_zero)
    assert sum(int(z.sum()) for z in near_zero) <= 0.05 * n_entries

    assert int(st["opt"]["step"]) == int(sj["opt"]["step"]) == 1
    moved = [np.zeros(z.shape, bool) for z in near_zero]
    for k in st["opt"]:
        if k == "step":
            continue
        got = opt.tree_leaves(st["opt"][k])
        want = jax.tree.leaves(sj["opt"][k], is_leaf=lambda x: isinstance(
            x, dict) and set(x) == {"q", "scale"})
        assert len(got) == len(want) == len(near_zero)
        for i, (g, w) in enumerate(zip(got, want)):
            if isinstance(g, dict):  # an int8 codec
                np.testing.assert_allclose(float(g["scale"]),
                                           float(w["scale"]), rtol=RTOL)
                d = np.abs(g["q"].numpy().astype(int)
                           - np.asarray(w["q"]).astype(int))
                assert d[~near_zero[i]].max(initial=0) <= 1, k
                moved[i] |= d > 0
            else:
                g, w = g.numpy(), np.asarray(w)
                assert np.abs(g - w).max() <= STATE_TOL * max(
                    np.abs(w).max(), 1e-30), k
    n_moved = sum(int((m & ~z).sum()) for m, z in zip(moved, near_zero))
    assert n_moved <= 1e-3 * n_entries
    for g, w, m, z in zip(tree_leaves(st["params"]),
                          jax.tree.leaves(sj["params"]), moved, near_zero):
        d = np.abs(g.numpy() - np.asarray(w))
        assert np.all((d <= ATOL_LR * lr) | m | z)
        assert d.max() <= (2 + ATOL_LR) * lr  # the exempt ones too
    # the step left its input as it was (the reference's undonated call)
    for t, w in zip(tree_leaves(tp), jax.tree.leaves(params)):
        np.testing.assert_array_equal(t.numpy(), w)


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor"])
def test_donated_step_is_bit_equal(name):
    """``donate=True`` writes the new state into the given tensors (the
    same objects come back) with the functional step's bits, three steps
    in a row."""
    _, tc = _cfgs()
    to = OptimizerConfig(name=name, lr=1e-3, warmup_steps=1, decay_steps=10)
    api = registry.get_model(ARCH, tc)
    params = _numpy_params()
    states = []
    for _ in range(2):
        p = registry.params_from_numpy(params, "cpu")
        states.append({"params": p, "opt": opt.init_opt_state(p, to)})
    functional = steps.make_train_step(api, to)
    donated = steps.make_train_step(api, to, donate=True)
    stream = MarkovLMStream(LMDataConfig(vocab_size=tc.vocab_size))
    ids = [id(t) for t in _codes(states[1])]
    for i in range(3):
        batch = {"tokens": torch.from_numpy(stream.batch(B, S, i)["tokens"])}
        states[0], m0 = functional(states[0], batch)
        out, m1 = donated(states[1], batch)
        assert out is states[1]
        assert [id(t) for t in _codes(out)] == ids
        for k in m0:
            assert torch.equal(m0[k], m1[k])
        for a, b in zip(_codes(states[0]), _codes(states[1]), strict=True):
            assert torch.equal(a, b)


def test_prefill_and_decode_steps():
    """``make_prefill_step`` / ``make_decode_step``: the argmax of the last
    logits as int32, the reference's on the same parameters, a decode step
    after ``pad_cache``."""
    jc, tc = _cfgs("yi-6b")
    params = _numpy_params("yi-6b")
    jp = jax.tree.map(jnp.asarray, params)
    tp = registry.params_from_numpy(params, "cpu")
    japi, tapi = j_registry.get_model("yi-6b", jc), registry.get_model(
        "yi-6b", tc)
    toks = _tokens(jc.vocab_size)
    want, jcache = jax.jit(j_steps.make_prefill_step(japi))(
        jp, {"tokens": jnp.asarray(toks)})
    got, cache = steps.make_prefill_step(tapi)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jcache, cache = j_pad_cache(jcache, S, S + 1), pad_cache(cache, S, S + 1)
    want, _ = jax.jit(j_steps.make_decode_step(japi))(
        jp, jcache, {"tokens": want[:, None]})
    got, _ = steps.make_decode_step(tapi)(tp, cache,
                                          {"tokens": got[:, None]})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# trainer + checkpoint (tests/test_training.py's cases on the port)
# ---------------------------------------------------------------------------


def _quadratic_setup(tmp, total=30, ckpt_every=10):
    target = torch.from_numpy(np.random.default_rng(0).normal(
        size=(32, 32)).astype(np.float32))
    ocfg = OptimizerConfig(lr=0.05, warmup_steps=0, decay_steps=1000,
                           weight_decay=0.0)

    def train_step(state, batch):
        w = state["params"]["w"].detach().requires_grad_()
        with torch.enable_grad():
            loss = torch.mean((w - target + batch["noise"] * 0) ** 2)
            (g,) = torch.autograd.grad(loss, [w])
        p2, o2, m = opt.apply_updates(state["params"], {"w": g},
                                      state["opt"], ocfg)
        return {"params": p2, "opt": o2}, dict(m, loss=loss.detach())

    def init_state():
        params = {"w": torch.zeros((32, 32))}
        return {"params": params, "opt": opt.init_opt_state(params, ocfg)}

    def make_batch(step):
        return {"noise": np.zeros((1,), np.float32)}

    tcfg = TrainerConfig(total_steps=total, log_every=50,
                         ckpt_every=ckpt_every, out_dir=str(tmp))
    return tcfg, train_step, init_state, make_batch


def _preempt_at(trainer, call: int):
    """Wrap the trainer's step so that the ``call``-th call triggers a
    preemption (as ``tests/test_training.py`` does)."""
    orig = trainer.step_fn
    calls = {"n": 0}

    def wrapped(state, batch):
        calls["n"] += 1
        if calls["n"] == call:
            trainer.preempt.trigger()
        return orig(state, batch)

    trainer.step_fn = wrapped


def test_trainer_runs_and_checkpoints(tmp_path):
    tcfg, step, init, mk = _quadratic_setup(tmp_path / "run")
    out = Trainer(tcfg, step, init, mk, device="cpu").run()
    assert out["metrics"]["loss"] < 0.5
    ck = Checkpointer(tmp_path / "run" / "ckpt")
    assert ck.steps() == [10, 20, 30]
    lines = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [0, 29]
    assert sorted(json.loads(lines[-1])) == ["grad_norm", "loss", "lr",
                                             "sec_per_step", "step"]


def test_trainer_resume_exact(tmp_path):
    """Preempted at call 13: checkpoint step 13, the resumed run starts at
    step 13 and ends at a straight-through run's loss."""
    tcfg, step, init, mk = _quadratic_setup(tmp_path / "a", total=30,
                                            ckpt_every=6)
    t = Trainer(tcfg, step, init, mk, device="cpu")
    _preempt_at(t, 13)
    t.run()
    ck = Checkpointer(tmp_path / "a" / "ckpt")
    assert ck.latest_step() == 13
    resumed = []
    out = Trainer(tcfg, step, init, mk, device="cpu").run(
        hooks=[lambda s, *_: resumed.append(s)])
    assert resumed == list(range(13, 30))
    assert out["metrics"]["loss"] < 0.5
    tcfg2, step2, init2, mk2 = _quadratic_setup(tmp_path / "b", total=30)
    ref = Trainer(tcfg2, step2, init2, mk2, device="cpu").run()
    assert out["metrics"]["loss"] == pytest.approx(ref["metrics"]["loss"],
                                                   rel=1e-4)


def _lm_trainer(tmp, total, ckpt_every, donate=True):
    """A reduced gemma2 through the port's ``Trainer`` on ``MarkovLMStream``
    batches, ``make_train_step(donate=...)``."""
    _, tc = _cfgs()
    api = registry.get_model(ARCH, tc)
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=2, decay_steps=total)
    stream = MarkovLMStream(LMDataConfig(vocab_size=tc.vocab_size))
    params = _numpy_params()

    def init_state():
        p = registry.params_from_numpy(params, "cpu")
        return {"params": p, "opt": opt.init_opt_state(p, ocfg)}

    def make_batch(step):
        return {"tokens": stream.batch(B, S, step)["tokens"]}

    tcfg = TrainerConfig(total_steps=total, log_every=1,
                         ckpt_every=ckpt_every, out_dir=str(tmp))
    return Trainer(tcfg, steps.make_train_step(api, ocfg, donate=donate),
                   init_state, make_batch, device="cpu")


def test_lm_trainer_resumes_exactly(tmp_path):
    """A reduced LM preempted at call 5 and resumed: the same losses step
    for step as an uninterrupted run (the CPU is deterministic), with
    donated and with functional steps."""
    t = _lm_trainer(tmp_path / "a", 9, 3)
    _preempt_at(t, 5)
    t.run()
    assert Checkpointer(tmp_path / "a" / "ckpt").steps() == [3, 5]
    out = _lm_trainer(tmp_path / "a", 9, 3).run()
    whole = _lm_trainer(tmp_path / "b", 9, 3, donate=False).run()

    def losses(run):
        return {json.loads(x)["step"]: json.loads(x)["loss"] for x in
                (tmp_path / run / "metrics.jsonl").read_text().splitlines()}

    assert losses("a") == losses("b")
    assert out["metrics"]["loss"] == whole["metrics"]["loss"]
    assert Checkpointer(tmp_path / "a" / "ckpt").steps() == [5, 6, 9]


def test_reference_checkpoint_resumed_by_port(tmp_path):
    """The reference's ``Trainer`` on a reduced gemma2, preempted at call
    5; the port's ``Trainer`` resumes from its checkpoint and ends within
    rel 1e-4 of the reference's uninterrupted run."""
    jc, _ = _cfgs()
    japi = j_registry.get_model(ARCH, jc)
    total = 8
    jo = j_opt.OptimizerConfig(lr=3e-3, warmup_steps=2, decay_steps=total)
    jstream = JMarkovLMStream(JLMDataConfig(vocab_size=jc.vocab_size))
    params = _numpy_params()

    def j_init():
        p = jax.tree.map(jnp.asarray, params)
        return {"params": p, "opt": j_opt.init_opt_state(p, jo)}

    def j_batch(step):
        return {"tokens": jstream.batch(B, S, step)["tokens"]}

    def j_trainer(out):
        return JTrainer(JTrainerConfig(total_steps=total, log_every=1,
                                       ckpt_every=3, out_dir=str(out)),
                        j_steps.make_train_step(japi, jo), j_init, j_batch)

    t = j_trainer(tmp_path / "a")
    orig, calls = t.step_fn, {"n": 0}

    def wrapped(state, batch):
        calls["n"] += 1
        if calls["n"] == 5:
            t.preempt.trigger()
        return orig(state, batch)

    t.step_fn = wrapped
    t.run()
    assert Checkpointer(tmp_path / "a" / "ckpt").latest_step() == 5
    out = _lm_trainer(tmp_path / "a", total, 3).run()
    ref = j_trainer(tmp_path / "b").run()
    assert out["metrics"]["loss"] == pytest.approx(ref["metrics"]["loss"],
                                                   rel=1e-4)


def test_bf16_checkpoints_cross_packages(tmp_path):
    """bfloat16 leaves: the port writes them as the reference does (two
    raw bytes an element, ``bfloat16`` in the manifest) and restores the
    reference's bit for bit, in a new tree or in place."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    JCheckpointer(tmp_path / "j").save(
        4, {"w": jnp.asarray(x, jnp.bfloat16), "n": jnp.arange(3)},
        blocking=True)
    want = torch.from_numpy(x).to(torch.bfloat16)
    tmpl = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
            "n": torch.zeros(3, dtype=torch.int32)}
    got, step = Checkpointer(tmp_path / "j").restore(tmpl)
    assert step == 4 and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], want) and got["n"].tolist() == [0, 1, 2]
    assert Checkpointer(tmp_path / "j").restore_into(tmpl) == 4
    assert torch.equal(tmpl["w"], want)
    Checkpointer(tmp_path / "t").save(4, {"w": want, "n": got["n"]},
                                      blocking=True)
    for d in ("j", "t"):
        manifest = json.loads((tmp_path / d / "step_4" /
                               "manifest.json").read_text())
        assert manifest["leaves"]["['w']"] == {"shape": [3, 5],
                                               "dtype": "bfloat16"}
    a = np.load(tmp_path / "j" / "step_4" / "shard_0.npz")["['w']"]
    b = np.load(tmp_path / "t" / "step_4" / "shard_0.npz")["['w']"]
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_restore_into_refuses_another_shape(tmp_path):
    """A stored leaf that would broadcast into a tree of another shape
    (a checkpoint of another config) raises and leaves the tree as it
    was; ``restore`` keeps the stored shape."""
    ck = Checkpointer(tmp_path)
    ck.save(1, {"w": torch.ones(1, 4)}, blocking=True)
    tree = {"w": torch.zeros(3, 4)}
    with pytest.raises(ValueError, match=r"\(1, 4\).*\(3, 4\)"):
        ck.restore_into(tree)
    assert torch.equal(tree["w"], torch.zeros(3, 4))
    assert ck.restore(tree)[0]["w"].shape == (1, 4)


# ---------------------------------------------------------------------------
# fault tolerance and the data pipeline
# ---------------------------------------------------------------------------


def test_straggler_monitor():
    m = StragglerMonitor(threshold=3.0)
    for i in range(20):
        assert not m.record(i, 0.1)
    assert m.record(20, 1.0)  # 10x median -> flagged
    assert m.flags[0][0] == 20
    assert m.median == pytest.approx(0.1)


def test_heartbeat(tmp_path):
    hb = Heartbeat(tmp_path / "hb", interval_s=0.05)
    time.sleep(0.15)
    assert not hb.stale(timeout_s=1.0)
    hb.stop()
    time.sleep(0.1)
    assert hb.stale(timeout_s=0.05)


def test_heartbeat_is_never_read_half_written(tmp_path):
    """The heartbeat file is rewritten aside and renamed, so a reader
    racing the writer never finds it empty (which reads as stale): the
    reference's ``write_text`` truncates the file in place, and its
    ``tests/test_training.py::test_heartbeat`` can fail that way."""
    hb = Heartbeat(tmp_path / "hb", interval_s=1e-4)
    try:
        time.sleep(0.01)
        assert not any(hb.stale(timeout_s=60.0) for _ in range(3000))
    finally:
        hb.stop()


def test_preemption_flag():
    p = PreemptionHandler(signals=())
    assert not p.preempted()
    p.trigger()
    assert p.preempted()


def test_prefetch_iterator_order_start_and_close():
    made = []

    def make(step):
        made.append(step)
        return {"x": np.full((2,), step, np.int64), "y": [np.arange(step)]}

    it = PrefetchIterator(make, start_step=7, depth=2, device="cpu")
    for want in range(7, 12):
        step, batch = next(it)
        assert step == want and batch["x"].tolist() == [want, want]
        assert isinstance(batch["y"][0], torch.Tensor)
        assert batch["y"][0].tolist() == list(range(want))
    it.close()
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()
    assert made == sorted(made) and made[0] == 7


def test_prefetch_iterator_raises_a_failed_batch():
    def make(step):
        if step == 2:
            raise ValueError("bad batch")
        return {"x": np.zeros(1)}

    it = PrefetchIterator(make, device="cpu")
    assert next(it)[0] == 0 and next(it)[0] == 1
    with pytest.raises(ValueError, match="bad batch"):
        next(it)
    it.close()


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _example():
    spec = importlib.util.spec_from_file_location(
        "serve_lm_torch", ROOT / "examples" / "serve_lm_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_launch_train_runs_on_the_cpu_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train

    argv = ["--arch", "xlstm-350m", "--steps", "12", "--batch", "2",
            "--seq", "16", "--out", str(tmp_path / "x"), "--device", "cpu"]
    out = train.main(argv)
    assert np.isfinite(out["metrics"]["loss"])
    assert Checkpointer(tmp_path / "x" / "ckpt").steps() == [10, 12]
    out = train.main(argv)  # everything done: resumes at the end
    assert "resumed from step 12" in capsys.readouterr().out
    assert out["metrics"] == {}


def test_serve_lm_example_runs_on_the_cpu(capsys):
    example = _example()
    assert example.main(["--fit-steps", "12", "--requests", "3",
                         "--device", "cpu"]) == 0
    assert "served 3 requests, 48 tokens" in capsys.readouterr().out
    out = example.run("gemma2-2b", 12, 2, "cpu")
    assert out["losses"][-1] < out["losses"][0]


def test_entry_points_need_a_gpu_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would train")
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="is_available"):
        train.main(["--steps", "1", "--out", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="is_available"):
        _example().main(["--fit-steps", "1"])
    with pytest.raises(RuntimeError, match="is_available"):
        PrefetchIterator(lambda s: {})
    tcfg, step, init, mk = _quadratic_setup(tmp_path / "t")
    with pytest.raises(RuntimeError, match="is_available"):
        Trainer(tcfg, step, init, mk)
    assert not (tmp_path / "o").exists() and not (tmp_path / "t").exists()
