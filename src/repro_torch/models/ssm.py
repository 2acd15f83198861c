"""xLSTM language model (xlstm-350m): mixed mLSTM/sLSTM block stack.

Blocks are heterogeneous (matrix vs scalar memory), so the layers are a
list, not a stacked tree.  Decode carries O(1) recurrent state per block.
With cfg.spiking=True the sLSTM blocks emit binary spikes through a
learnable threshold (the paper's RSNN technique applied to this family).

The reference's ``models/ssm.py`` in plain PyTorch.  ``cfg.remat ==
"full"`` checkpoints each block in train mode (``torch.utils.checkpoint``
where the reference calls ``jax.checkpoint``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import basic
from repro_torch.models.layers import xlstm as xl


def is_slstm(cfg, i: int) -> bool:
    return i in cfg.ssm.slstm_layers


def init_xlstm_lm(generator: torch.Generator, cfg,
                  device: torch.device | str = "cuda") -> dict:
    """The parameter tree, drawn from ``generator`` (``basic.ParamInit``);
    ``device="meta"`` gives shapes and dtypes only."""
    init = basic.ParamInit(generator, device)
    params = {"embed": basic.init_embedding(init, cfg)}
    params["layers"] = [
        {"norm": basic.init_norm(init, cfg, cfg.d_model),
         "block": (xl.init_slstm if is_slstm(cfg, i) else xl.init_mlstm)(
             init, cfg)}
        for i in range(cfg.num_layers)]
    params["final_norm"] = basic.init_norm(init, cfg, cfg.d_model)
    return params


def init_xlstm_state(cfg, batch: int,
                     device: torch.device | str = "cuda") -> list:
    return [xl.init_slstm_state(cfg, batch, device) if is_slstm(cfg, i)
            else xl.init_mlstm_state(cfg, batch, device)
            for i in range(cfg.num_layers)]


def xlstm_forward(params, tokens, cfg, states: list | None = None,
                  mode: str = "train") -> tuple[torch.Tensor, list | None]:
    """states!=None => decode mode (S==1); states is the per-block carry.
    mode='prefill' returns the final per-block states as the decode cache."""
    mode = "decode" if states is not None else mode
    x = basic.embed_tokens(tokens, params["embed"], cfg)
    new_states = []
    for i, lp in enumerate(params["layers"]):
        h = basic.apply_norm(x, lp["norm"], cfg)
        block = xl.slstm_block if is_slstm(cfg, i) else xl.mlstm_block
        st = states[i] if states is not None else None
        if cfg.remat == "full" and mode == "train":
            out, ns = checkpoint(block, h, lp["block"], cfg, st,
                                 use_reentrant=False)
        else:
            out, ns = block(h, lp["block"], cfg, st)
        x = x + out
        new_states.append(ns)
    if mode == "prefill":
        x = x[:, -1:]
    x = basic.apply_norm(x, params["final_norm"], cfg)
    logits = basic.unembed(x, params["embed"], cfg)
    return logits, (new_states if mode in ("decode", "prefill") else None)
