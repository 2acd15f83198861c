"""The SPMD token-LM train step over gloo ranks on the CPU: the rank side
and the parent's helpers for ``tests/test_torch_spmd_*.py``.

Run as a script, this file is one rank of a job:

    python tests/torch_spmd.py SCENARIO RANK WORLD STORE OUT [ARGS...]

joining a gloo process group over the ``FileStore`` at STORE (loopback
only: the parent sets ``GLOO_SOCKET_IFNAME=lo``), one ``torch`` thread a
rank, writing what the parent checks under OUT.  The scenarios:

``archs MESH ARCH,...``
    For each arch at ``reduce_config``: the seeded init drawn on the CPU
    generator and placed on the mesh of ranks MESH (``2x2``), one
    ``loss_and_grads`` and two donated AdamW train steps on ``batch(cfg)``;
    every rank checks that each parameter, gradient and optimizer-state
    leaf carries its spec's placements, that each placed leaf's local
    tensor is the block ``shard_slices`` names for its coordinate (and
    gathers back to the global leaf), and sums
    its local bytes against ``with_shardings``' blocks (``rank<r>.json``);
    for zamba2 the most bytes of gathered layers alive at once in a
    ``loss_and_grads`` with remat "full" and with none; once, the error
    of a strict view no strategy takes.  Rank 0 writes the
    losses, grad norms, gathered gradients and gathered parameters
    (``<arch>.npz``).
``trainer MESH STOP_AT TOTAL ARCH DIR``
    A ``Trainer`` in DIR on the mesh MESH over ``trainer_batch``, resuming
    from DIR's checkpoint if there is one; with STOP_AT >= 0 rank 1 alone
    is preempted after step STOP_AT.  Each rank writes the steps it ran
    and its last metrics (``rank<r>.json``).

The parent side (``run_ranks``, ``plain_steps``, ``plain_trainer``)
spawns the ranks with ``sys.executable`` and computes the one-device
counterparts in its own process.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
B, S = 8, 16  # the reference test's batch: 128 tokens, two MoE groups
LR = 3e-4  # OptimizerConfig's default: the AdamW rate of every case here
TRAINER_BATCH, TRAINER_SEQ = 8, 16
RANK_TIMEOUT = 300  # seconds a job of ranks may take before it is killed


def ocfg(lr: float = LR, decay_steps: int = 10):
    from repro_torch.training.optimizer import OptimizerConfig
    return OptimizerConfig(name="adamw", lr=lr, warmup_steps=1,
                           decay_steps=decay_steps)


def model(arch: str):
    from repro_torch.models import registry
    cfg = registry.reduce_config(registry.get_model(arch).cfg)
    return cfg, registry.get_model(arch, cfg)


def batch(cfg, seed: int = 1) -> dict:
    """The arch cases' seeded numpy batch (whisper's ``frames``,
    internvl2's ``patch_embeds``)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.frontend == "patch":
        out["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def init_params(api):
    return api.init(torch.Generator().manual_seed(0), device="cpu")


def trainer_batch(cfg):
    from repro_torch.data.synthetic import LMDataConfig, MarkovLMStream
    stream = MarkovLMStream(LMDataConfig(vocab_size=cfg.vocab_size))
    return lambda s: {"tokens": stream.batch(TRAINER_BATCH, TRAINER_SEQ,
                                             s)["tokens"]}


def trainer_config(out: Path, total: int):
    from repro_torch.training.trainer import TrainerConfig
    return TrainerConfig(total_steps=total, log_every=1, ckpt_every=100,
                         out_dir=str(out), resume=True)


# ------------------------------------------------------------- the parent


def run_ranks(tmp: Path, world: int, scenario: str, out: Path, *args,
              timeout: float = RANK_TIMEOUT) -> list[str]:
    """``world`` ranks of ``scenario`` as processes over a ``FileStore``
    in ``tmp``; every rank must exit 0 (a rank still running at
    ``timeout`` is killed).  Returns the ranks' standard outputs."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1"}
    store = tmp / f"store_{scenario}_{world}_{out.name}"
    out.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__)), scenario, str(r), str(world),
         str(store), str(out), *map(str, args)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:  # a rank left waiting on the others
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-4000:]}"
    return [o for o, _ in outs]


def plain_steps(arch: str, n: int = 2) -> dict:
    """The one-device counterpart of the ``archs`` scenario: the same
    init and batch, plain tensors."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import steps
    from repro_torch.training import optimizer as opt_lib
    cfg, api = model(arch)
    params = init_params(api)
    b = {k: torch.from_numpy(v) for k, v in batch(cfg).items()}
    loss0, grads = steps.loss_and_grads(api, params, b)
    state = {"params": params, "opt": opt_lib.init_opt_state(params,
                                                               ocfg())}
    step = steps.make_train_step(api, ocfg(), donate=True)
    losses, gnorms = [], []
    for _ in range(n):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return {"loss0": float(loss0), "grads": [g.numpy() for g in grads],
            "losses": losses, "gnorms": gnorms,
            "params": [p.numpy() for p in tree_leaves(state["params"])]}


def plain_trainer(arch: str, out: Path, total: int) -> dict:
    """A one-device ``Trainer`` of the ``trainer`` scenario's seed and
    batches for ``total`` steps."""
    from repro_torch.launch import steps
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.trainer import Trainer
    cfg, api = model(arch)

    def init_state():
        params = init_params(api)
        return {"params": params, "opt": opt_lib.init_opt_state(params,
                                                                 ocfg())}

    return Trainer(trainer_config(out, total),
                   steps.make_train_step(api, ocfg(), donate=True),
                   init_state, trainer_batch(cfg), device="cpu").run()


GRAD_RTOL = 1e-5  # of the leaf's largest |gradient|
LOSS_ATOL = 1e-5  # the losses and grad norms
# parameters after AdamW steps: an update divides each gradient element by
# its own running magnitude, so an element whose gradient is near zero
# moves by up to the rate whatever the float error of that gradient; the
# parameters are held to a tenth of the rate (and the gradients, above,
# to GRAD_RTOL)
PARAM_ATOL_PER_LR = 0.1


def check_arch(arch: str, out: Path, world: int) -> None:
    """The ``archs`` scenario's results for ``arch`` against the
    one-device steps."""
    got = np.load(out / f"{arch}.npz")
    want = plain_steps(arch)
    assert abs(float(got["loss0"]) - want["loss0"]) <= LOSS_ATOL
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(got["gnorms"], want["gnorms"], rtol=0,
                               atol=LOSS_ATOL * max(want["gnorms"]))
    for i, w in enumerate(want["grads"]):
        g = got[f"g{i}"]
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= GRAD_RTOL * max(np.abs(w).max(),
                                                      1e-30), i
    for i, w in enumerate(want["params"]):
        p = got[f"p{i}"]
        assert p.shape == w.shape
        np.testing.assert_allclose(p, w, rtol=0,
                                   atol=PARAM_ATOL_PER_LR * LR)


def rank_report(out: Path, rank: int) -> dict:
    """What rank ``rank`` wrote (``rank<r>.json``)."""
    return json.loads((out / f"rank{rank}.json").read_text())


def check_placements(arch: str, out: Path, world: int) -> None:
    """Every rank's placement and bytes report for ``arch``."""
    for r in range(world):
        rep = rank_report(out, r)[arch]
        assert rep["blocks_exact"], r
        assert rep["wrong_placements"] == [], (r, rep["wrong_placements"])
        assert rep["loss_replicated"] and rep["metrics_replicated"]
        assert rep["local_bytes"] == rep["block_bytes"], (r, rep)
        assert rep["local_bytes"] < rep["global_bytes"], (r, rep)


def metrics_log(out: Path) -> dict:
    """``metrics.jsonl``'s records by step."""
    recs = [json.loads(ln) for ln in
            (out / "metrics.jsonl").read_text().splitlines()]
    return {r["step"]: r for r in recs}


# --------------------------------------------------------------- the rank


def _mesh(shape: str):
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_rank_mesh
    mesh = make_rank_mesh(tuple(int(n) for n in shape.split("x")),
                          ("data", "model"), "cpu")
    shd.set_activation_axes(mesh)
    return mesh


def _specs_of(tree, axis_names):
    from repro_torch.core.tree import tree_leaves
    from repro_torch.distributed.sharding import placements_spec
    return [placements_spec(t.placements, axis_names, t.dim())
            for t in tree_leaves(tree)]


def _check_arch(arch: str, mesh, rank: int, out: Path) -> dict:
    from repro_torch.core.tree import tree_leaves, tree_leaves_with_path
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.runtime.elastic import local_slices, reshard_state
    from repro_torch.training import optimizer as opt_lib

    cfg, api = model(arch)
    params = init_params(api)
    pspecs = shd.tree_param_specs(params, mesh)
    (placed,) = reshard_state(params, mesh)
    # this rank's block, and DTensor's own reading of the blocks: the
    # gathered leaf is the global one
    blocks_exact = all(
        torch.equal(t.to_local(), p[local_slices(t)])
        and torch.equal(t.full_tensor(), p)
        for t, p in zip(tree_leaves(placed), tree_leaves(params)))
    b = {k: torch.from_numpy(v) for k, v in batch(cfg).items()}
    loss0, grads = steps.loss_and_grads(api, placed, b)
    state = {"params": placed, "opt": opt_lib.init_opt_state(placed,
                                                              ocfg())}
    ospecs = opt_lib.state_specs(pspecs, params, ocfg())
    step = steps.make_train_step(api, ocfg(), donate=True)
    losses, gnorms, replicated = [], [], True
    for _ in range(2):
        state, m = step(state, b)
        replicated &= all(all(p.is_replicate() for p in v.placements)
                          for v in m.values())
        losses.append(float(m["loss"].to_local()))
        gnorms.append(float(m["grad_norm"].to_local()))
    names = mesh.axis_names
    wrong = [p for (p, _), got, want in zip(
        tree_leaves_with_path({"params": state["params"], "grads": grads,
                               "opt": state["opt"]}),
        _specs_of(state["params"], names) + _specs_of(grads, names)
        + _specs_of(state["opt"], names),
        tree_leaves(pspecs) * 2 + tree_leaves(ospecs), strict=True)
        if tuple(got) != tuple(want)]
    resident = {"params": state["params"], "opt": state["opt"]}
    blocks = shd.with_shardings(resident, {"params": pspecs, "opt": ospecs},
                                mesh)
    report = {
        "blocks_exact": blocks_exact,
        "wrong_placements": wrong,
        "loss_replicated": all(p.is_replicate() for p in loss0.placements),
        "metrics_replicated": replicated,
        "local_bytes": sum(t.to_local().nbytes for t in
                           tree_leaves(resident)),
        "block_bytes": sum(s.block_bytes for s in tree_leaves(blocks)),
        "global_bytes": sum(t.numel() * t.element_size()
                            for t in tree_leaves(resident)),
    }
    if arch == "zamba2-7b":
        report["gathered"] = _gathered_peaks(arch, placed, b)
    full_grads = [g.full_tensor().numpy() for g in grads]
    full_params = [p.full_tensor().numpy()
                   for p in tree_leaves(state["params"])]
    if rank == 0:
        np.savez(out / f"{arch}.npz", loss0=float(loss0.to_local()),
                 losses=losses, gnorms=gnorms,
                 **{f"g{i}": g for i, g in enumerate(full_grads)},
                 **{f"p{i}": p for i, p in enumerate(full_params)})
    return report


def _gathered_peaks(arch: str, placed, b) -> dict:
    """The most bytes of gathered layers alive at once (checked at each
    gather, ``core/tree.py`` ``_gather_layer``) in one ``loss_and_grads``
    of ``arch`` with remat "full" and with none, and the bytes of one
    gathered layer: zamba2's ``groups`` leaves split on the inner layer
    axis."""
    import dataclasses

    from repro_torch.core import tree
    from repro_torch.core.tree import tree_leaves_with_path
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from torch.distributed.tensor import Shard

    real = tree._gather_layer

    def peak(remat: str) -> int:
        cfg = dataclasses.replace(model(arch)[0], remat=remat)
        held, most = [], 0

        def tracked(t, i):
            nonlocal most
            out = real(t, i)
            held.append(out.to_local().untyped_storage())
            most = max(most, sum(s.nbytes() for s in held if
                                 torch._C._storage_Use_Count(s._cdata) > 1))
            return out

        tree._gather_layer = tracked
        try:
            steps.loss_and_grads(registry.get_model(arch, cfg), placed, b)
        finally:
            tree._gather_layer = real
        return most

    layer = sum(t.numel() // (t.shape[0] * t.shape[1]) * t.element_size()
                for p, t in tree_leaves_with_path(placed)
                if p.startswith("['groups']") and Shard(1) in t.placements)
    return {"full": peak("full"), "none": peak("none"), "layer": layer}


def _view_refusal(mesh) -> str:
    """The error of a strict view that DTensor refuses and no strategy of
    ``distributed/dtensor_ops.py`` takes: a (6, 4) leaf split over
    ``data`` on dimension 0, viewed as (3, 2, 4) (a split of the sharded
    dimension into sizes that ``data`` does not divide)."""
    from repro_torch.core.tree import PartitionSpec as P
    from repro_torch.runtime.elastic import place_leaf
    x = place_leaf(torch.zeros(6, 4), P("data"), mesh)
    try:
        x.view(3, 2, 4)
    except RuntimeError as e:
        return str(e)
    return ""


def _trainer(mesh, rank: int, stop_at: int, total: int, arch: str,
             out: Path) -> dict:
    from repro_torch.launch import steps
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.trainer import Trainer

    cfg, api = model(arch)
    def init_state():
        (params,) = reshard_state(init_params(api), mesh)
        return {"params": params, "opt": opt_lib.init_opt_state(params,
                                                                 ocfg())}

    trainer = Trainer(trainer_config(out, total),
                      steps.make_train_step(api, ocfg(), donate=True),
                      init_state, trainer_batch(cfg), device="cpu")
    seen = []

    def hook(step, state, metrics):
        seen.append(step)
        if step == stop_at and rank == 1:
            trainer.preempt.trigger()

    res = trainer.run(hooks=[hook])
    return {"steps": seen, "metrics": res["metrics"]}


def main(argv) -> None:
    import torch.distributed as dist

    scenario, rank, world, store, out, *args = argv
    rank, world, out = int(rank), int(world), Path(out)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = _mesh(args[0])
        if scenario == "archs":
            report = {a: _check_arch(a, mesh, rank, out)
                      for a in args[1].split(",")}
            report["view_refusal"] = _view_refusal(mesh)
        else:
            report = _trainer(mesh, rank, int(args[1]), int(args[2]),
                              args[3], Path(args[4]))
        (out / f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    main(sys.argv[1:])
