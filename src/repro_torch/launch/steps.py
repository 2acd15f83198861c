"""Train / prefill / decode step factories + input shape builders.

The reference's ``launch/steps.py`` in plain PyTorch: the steps run
eagerly (no ``jit``), gradients come from ``torch.autograd.grad`` over the
state's parameter leaves, and ``batch_shapes`` gives tensors on the
``meta`` device where the reference gives ``jax.ShapeDtypeStruct``s.

A state placed on a mesh of ranks (``runtime/elastic.py`` ``place_state``:
DTensor leaves) makes the train step SPMD, the counterpart of the
reference's jitted step under its mesh: the batch is placed by
``batch_specs``, the forward and backward run on DTensors under
``implicit_replication`` (the forward's plain constant tensors, RoPE
tables and masks, count as replicated, as GSPMD treats constants) and
DTensor's sharding propagation places the activations and inserts the
collectives.  An op with no sharding strategy raises.  Each gradient is
redistributed to its parameter's placements before the update; the loss
and the metrics are replicated scalars.  On a (1, 1) mesh the same aten
ops run on the same local tensors as the plain step.
"""

from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.distributed.sharding import batch_specs
from repro_torch.launch.mesh import mesh_of
from repro_torch.models.registry import ModelAPI
from repro_torch.runtime.elastic import place_leaf
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.optimizer import OptimizerConfig


def ce_next_token_loss(logits: torch.Tensor,
                       tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy in fp32, in the reference's formulation:
    the target log-prob is picked with an ``arange == target`` mask (no
    gather over the vocab dim), logsumexp around the detached row max (the
    reference's ``stop_gradient``).  The reference's vocab-dim sharding
    constraint is a no-op on one device."""
    logits = logits[:, :-1].to(torch.float32)
    targets = tokens[:, 1:]
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    vocab_ids = torch.arange(logits.shape[-1], dtype=targets.dtype,
                             device=logits.device)
    tgt = torch.sum(torch.where(vocab_ids == targets[..., None], logits,
                                0.0), dim=-1)
    return torch.mean(lse - tgt)


def rank_mesh(tree):
    """The ``Mesh`` of ranks a tree's DTensor leaves are placed on
    (``launch/mesh.py`` ``mesh_of`` their ``DeviceMesh``), or ``None`` for
    a tree of plain tensors."""
    leaf = next((t for t in tree_leaves(tree) if isinstance(t, DTensor)),
                None)
    return None if leaf is None else mesh_of(leaf.device_mesh)


def place_batch(batch: dict, mesh) -> dict:
    """Each plain leaf of the global ``batch`` (every rank holds the same)
    as a DTensor on the mesh of ranks, by ``batch_specs``: this rank's
    block of the data axes."""
    specs = batch_specs(batch, mesh)
    return {k: v if isinstance(v, DTensor) else place_leaf(v, specs[k], mesh)
            for k, v in batch.items()}


def spmd(mesh):
    """The context an SPMD step runs in: ``implicit_replication`` on a
    mesh of ranks, nothing otherwise."""
    return implicit_replication() if mesh is not None else \
        contextlib.nullcontext()


def _replicate_in_backward(loss: torch.Tensor) -> None:
    """Keep ``implicit_replication`` on while autograd runs ``loss``'s
    backward, which it may run on a thread of its own (a CUDA device's),
    where the switch may not be set: on at the root node, back to what it
    was once the backward ends."""
    dispatcher = DTensor._op_dispatcher

    def on(grad_outputs):
        was = dispatcher._allow_implicit_replication
        dispatcher._allow_implicit_replication = True

        def off():
            dispatcher._allow_implicit_replication = was

        torch.autograd.Variable._execution_engine.queue_callback(off)

    loss.grad_fn.register_prehook(on)


def loss_and_grads(api: ModelAPI, params, batch: dict):
    """The train-mode loss of ``batch`` and its gradient, a leaf for each
    leaf of ``params`` in ``tree_leaves`` order (zeros for a leaf the loss
    does not reach, as ``jax.grad`` gives).  On a mesh of ranks the batch
    is placed first (``place_batch``), each gradient comes back with its
    parameter's placements and the loss replicated."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    mesh = rank_mesh(leaves)
    if mesh is not None:
        batch = place_batch(batch, mesh)
    with torch.enable_grad(), spmd(mesh):
        logits, _ = api.forward(tree_unflatten(params, iter(leaves)), batch,
                                mode="train")
        loss = ce_next_token_loss(logits, batch["tokens"])
        del logits
        if mesh is not None:
            _replicate_in_backward(loss)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    loss = loss.detach()
    if mesh is None:
        return loss, list(grads)
    grads = [g.redistribute(p.device_mesh, p.placements)
             for g, p in zip(grads, leaves)]
    return loss.redistribute(loss.device_mesh,
                             [Replicate()] * loss.device_mesh.ndim), grads


def make_train_step(api: ModelAPI, ocfg: OptimizerConfig,
                    donate: bool = False):
    """``train_step(state, batch) -> (state, metrics)``, ``state`` =
    ``{"params", "opt"}``, metrics ``loss``, ``grad_norm`` and ``lr``
    (0-d tensors).  ``donate=False``: ``apply_updates`` makes a new state
    and leaves the given one as it was.  ``donate=True`` (the counterpart
    of the reference's ``donate_argnums=(0,)``): ``apply_updates_``
    overwrites the given state's tensors leaf by leaf and returns it, so
    that a step holds one state and one leaf's float32 temporaries, not
    two states; the values are bit-equal.  A state on a mesh of ranks
    (DTensor leaves) makes the step SPMD (the module's docstring); every
    rank calls it with the same global batch."""
    def train_step(state: dict, batch: dict):
        loss, grads = loss_and_grads(api, state["params"], batch)
        with spmd(rank_mesh(state["params"])):
            if donate:
                params, opt, metrics = opt_lib.apply_updates_(
                    state["params"], grads, state["opt"], ocfg)
            else:
                params, opt, metrics = opt_lib.apply_updates(
                    state["params"],
                    tree_unflatten(state["params"], iter(grads)),
                    state["opt"], ocfg)
        del grads
        metrics = dict(metrics, loss=loss)
        if donate:
            return state, metrics
        return {"params": params, "opt": opt}, metrics

    return train_step


def make_prefill_step(api: ModelAPI):
    @torch.no_grad()
    def prefill_step(params, batch: dict):
        logits, cache = api.forward(params, batch, mode="prefill")
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, cache

    return prefill_step


def make_decode_step(api: ModelAPI):
    @torch.no_grad()
    def decode_step(params, cache, batch: dict):
        logits, new_cache = api.forward(params, batch, cache=cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, new_cache

    return decode_step


# ---------------------------------------------------------------------------
# Input shape builders (tensors on the meta device: no allocation)
# ---------------------------------------------------------------------------


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    out = {"tokens": meta((b, s), torch.int32)}
    if shape.kind != "decode":
        if cfg.frontend == "patch":
            out["patch_embeds"] = meta((b, cfg.num_patch_tokens, cfg.d_model),
                                       cfg.dtype)
        if cfg.family == "audio":
            out["frames"] = meta((b, cfg.encoder_seq, cfg.d_model),
                                 cfg.dtype)
    return out
