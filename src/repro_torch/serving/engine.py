"""Batched token-LM serving: prefill + decode with KV caches,
greedy/temperature sampling, and a simple continuous-batching request queue.

The per-family cache layouts live with the models (KVCache / MLACache);
this module drives them.  `generate` is the one-shot batched API;
`ServeLoop` packs a request queue into fixed-size decode batches
(slot-based continuous batching: a finished slot is refilled from the
queue without stopping the batch).

The reference's ``serving/engine.py`` on the port's models, eager where
the reference jits.  Like the reference, `generate` decodes into the
prefill cache as it comes, exactly prompt-sized: every decode write lands
past its end and is dropped (``attention._scatter_cache``), so each new
token attends to the prompt only.  Decode is exact where the caller pads
the cache first (``serving/cache_utils.py`` ``pad_cache``), as the
teacher-forced checks do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.registry import ModelAPI
from repro_torch.serving.slots import SlotScheduler


@dataclasses.dataclass
class SamplerConfig:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0
    eos_id: int = -1  # -1: never stop early


def sample(logits: torch.Tensor, scfg: SamplerConfig,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32.  Greedy picks the first maximum, as
    ``jnp.argmax`` does; temperature sampling draws from ``generator``
    (the reference's draws come from a JAX key, so only their support
    matches)."""
    if scfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / scfg.temperature
    if scfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -scfg.top_k][:, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def make_steps(api: ModelAPI, scfg: SamplerConfig):
    def prefill(params, batch, generator):
        logits, cache = api.forward(params, batch, mode="prefill")
        tok = sample(logits[:, -1], scfg, generator)
        return tok, cache

    def decode(params, cache, tok, generator):
        logits, cache = api.forward(params, {"tokens": tok[:, None]},
                                    cache=cache)
        nxt = sample(logits[:, -1], scfg, generator)
        return nxt, cache

    return prefill, decode


def params_device(params) -> torch.device:
    """The device of a parameter tree (its embedding's)."""
    return params["embed"]["tok"].device


@torch.no_grad()
def generate(api: ModelAPI, params, prompts, max_new_tokens: int,
             scfg: SamplerConfig = SamplerConfig(), seed: int = 0,
             extra_inputs: dict | None = None) -> np.ndarray:
    """prompts: (B, S) int -> (B, max_new_tokens) generated ids, on the
    device the parameters lie on."""
    prefill, decode = make_steps(api, scfg)
    dev = params_device(params)
    generator = torch.Generator(device=dev).manual_seed(seed)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in (extra_inputs or {}).items()}
    batch["tokens"] = torch.as_tensor(prompts, device=dev)
    tok, cache = prefill(params, batch, generator)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        tok, cache = decode(params, cache, tok, generator)
        out.append(tok)
    return torch.stack(out, dim=1).cpu().numpy()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeLoop(SlotScheduler):
    """Slot-based continuous batching over a fixed decode batch.

    The queue/slot/finished bookkeeping is ``serving.slots.SlotScheduler``
    — the same scheduler the streaming RSNN loops run on.  Each slot holds
    one active request; when a request finishes (EOS or max_new), the slot
    is refilled from the queue.  Caches are refreshed by re-running
    prefill over the active set: prompts left-padded with token 0 to the
    longest (the pads are attended to), ``generate`` for the longest
    ``max_new``, each output cut to its request's ``max_new`` and at EOS."""

    def __init__(self, api: ModelAPI, params, batch_slots: int = 4,
                 scfg: SamplerConfig = SamplerConfig()):
        super().__init__(batch_slots)
        self.api, self.params, self.scfg = api, params, scfg

    def submit(self, prompt: np.ndarray, max_new: int) -> int:
        rid = self._new_sid()
        self.queue.append(Request(rid, prompt, max_new))
        return rid

    def run(self) -> list[Request]:
        while self.has_work:
            self._refill()
            active = [(i, r) for i, r in enumerate(self.slot_req)
                      if r is not None]
            width = max(len(r.prompt) for _, r in active)
            prompts = np.stack([np.pad(r.prompt, (width - len(r.prompt), 0))
                                for _, r in active])
            steps = max(r.max_new for _, r in active)
            toks = generate(self.api, self.params, prompts, steps, self.scfg)
            for (i, r), row in zip(active, toks):
                r.out = list(row[: r.max_new])
                if self.scfg.eos_id >= 0 and self.scfg.eos_id in r.out:
                    r.out = r.out[: r.out.index(self.scfg.eos_id) + 1]
                self._finish_slot(i)
        return self.finished
