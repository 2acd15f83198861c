"""Optimizers: AdamW, AdamW with 8-bit states, Adafactor (+ int8 momentum).

Pure functions over a parameter tree: a dict of tensors whose ``lif*``
leaves are ``LIFParams`` (the RSNN's parameter dict), with optimizer state
of the same structure.  ``apply_updates`` returns new tensors and leaves
its inputs as they were; it runs under ``torch.no_grad()`` on the
parameters' device.  The formulas are the reference's, in its order of
float operations, and every division by a constant divides by a tensor
on the operand's device (PyTorch divides a CUDA tensor by a host scalar as
a product with its reciprocal).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # adamw | adamw8bit | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000


# ------------------------------------------------------------ the trees


def _is_leaf(x) -> bool:
    """A tensor, or an int8 codec's ``{"q", "scale"}`` (one leaf, as the
    reference's ``is_leaf`` treats it)."""
    return isinstance(x, torch.Tensor) or (isinstance(x, dict)
                                           and set(x) == {"q", "scale"})


def tree_leaves(tree) -> list:
    if _is_leaf(tree):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for sub in items for leaf in tree_leaves(sub)]


def tree_unflatten(like, it):
    if _is_leaf(like):
        return next(it)
    if isinstance(like, dict):
        return {k: tree_unflatten(v, it) for k, v in like.items()}
    return type(like)(*(tree_unflatten(v, it) for v in like))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in ``tree``'s structure."""
    cols = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, iter([fn(*xs) for xs in zip(*cols)]))


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d``, divided as the reference divides (IEEE, by a float32)."""
    return x / torch.full((), d, dtype=torch.float32, device=x.device)


def schedule(ocfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warm-up, then a cosine decay to 10% of ``lr``; float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(_div(step, max(ocfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp(_div(step - ocfg.warmup_steps,
                            max(ocfg.decay_steps - ocfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return ocfg.lr * warm * (0.1 + 0.9 * cos)


# ------------------------------------------------ int8 tensor codecs


def _q8(x: torch.Tensor) -> dict:
    """Linear int8 with one scale a tensor."""
    scale = _div(torch.clamp(x.abs().max(), min=1e-12), 127.0)
    return {"q": torch.clamp(torch.round(x / scale), -127,
                             127).to(torch.int8),
            "scale": scale.to(torch.float32)}


def _dq8(t: dict) -> torch.Tensor:
    return t["q"].to(torch.float32) * t["scale"]


# Nonnegative second moments span ~30 decades early in training; linear int8
# truncates small v to 0 and the 1/sqrt(v) update explodes.  v is stored in
# the log domain instead (~0.16 log-resolution, < 9% relative error on
# sqrt(v)).
_LOG_LO, _LOG_HI = -40.0, 2.0


def _q8log(x: torch.Tensor) -> dict:
    l = torch.log(torch.clamp(x, min=1e-38))
    q = torch.round(_div(torch.clamp(l, _LOG_LO, _LOG_HI) - _LOG_LO,
                         _LOG_HI - _LOG_LO) * 254.0) - 127.0
    q = torch.where(x <= 0.0, -128.0, q).to(torch.int8)  # exact zero: -128
    return {"q": q, "scale": torch.ones((), dtype=torch.float32,
                                        device=x.device)}


def _dq8log(t: dict) -> torch.Tensor:
    q = t["q"].to(torch.float32)
    l = _div(q + 127.0, 254.0) * (_LOG_HI - _LOG_LO) + _LOG_LO
    return torch.where(q <= -128.0, 0.0, torch.exp(l))


def _is_factored(x: torch.Tensor) -> bool:
    return x.dim() >= 2 and x.shape[-1] >= 128 and x.shape[-2] >= 128


# ------------------------------------------------------- init / update


def init_opt_state(params, ocfg: OptimizerConfig) -> dict:
    dev = tree_leaves(params)[0].device

    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step = torch.zeros((), dtype=torch.int32, device=dev)
    if ocfg.name == "adamw":
        return {"step": step, "m": tree_map(f32, params),
                "v": tree_map(f32, params)}
    if ocfg.name == "adamw8bit":
        return {"step": step, "m": tree_map(lambda p: _q8(f32(p)), params),
                "v": tree_map(lambda p: _q8log(f32(p)), params)}
    if ocfg.name == "adafactor":
        def vrow(p):
            return (torch.zeros(p.shape[:-1], dtype=torch.float32,
                                device=p.device)
                    if _is_factored(p) else f32(p))

        def vcol(p):
            return torch.zeros(p.shape[:-2] + p.shape[-1:]
                               if _is_factored(p) else (),
                               dtype=torch.float32, device=p.device)

        return {"step": step, "m": tree_map(lambda p: _q8(f32(p)), params),
                "vr": tree_map(vrow, params), "vc": tree_map(vcol, params)}
    raise ValueError(ocfg.name)


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params, grads, state: dict, ocfg: OptimizerConfig):
    """Returns (new_params, new_state, metrics: ``grad_norm``, ``lr``)."""
    step = state["step"] + 1
    lr = schedule(ocfg, step)
    gnorm = _global_norm(grads)
    clip = torch.clamp(torch.full_like(gnorm, ocfg.grad_clip)
                       / torch.clamp(gnorm, min=1e-12), max=1.0)
    grads = tree_map(lambda g: g.to(torch.float32) * clip, grads)
    t = step.to(torch.float32)
    bc1 = 1.0 - ocfg.b1 ** t
    bc2 = 1.0 - ocfg.b2 ** t

    def upd_param(p, u):
        wd = ocfg.weight_decay * p.to(torch.float32) if p.dim() >= 2 else 0.0
        return (p.to(torch.float32) - lr * (u + wd)).to(p.dtype)

    if ocfg.name == "adamw":
        m = tree_map(lambda m, g: ocfg.b1 * m + (1 - ocfg.b1) * g,
                     state["m"], grads)
        v = tree_map(lambda v, g: ocfg.b2 * v + (1 - ocfg.b2) * g * g,
                     state["v"], grads)
        upd = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2)
                                                 + ocfg.eps), m, v)
        new_state = {"step": step, "m": m, "v": v}
    elif ocfg.name == "adamw8bit":
        m = tree_map(lambda mq, g: _q8(ocfg.b1 * _dq8(mq)
                                       + (1 - ocfg.b1) * g),
                     state["m"], grads)
        v = tree_map(lambda vq, g: _q8log(ocfg.b2 * _dq8log(vq)
                                          + (1 - ocfg.b2) * g * g),
                     state["v"], grads)
        upd = tree_map(lambda mq, vq: (_dq8(mq) / bc1)
                       / (torch.sqrt(_dq8log(vq) / bc2) + ocfg.eps), m, v)
        new_state = {"step": step, "m": m, "v": v}
    elif ocfg.name == "adafactor":
        d = 1.0 - ocfg.b2 ** t

        def factored(g, vc):
            return g.dim() >= 2 and vc.dim() > 0

        def upd_vr(g, vr, vc):
            if factored(g, vc):
                return ocfg.b2 * vr + (1 - ocfg.b2) * torch.mean(g * g,
                                                                 dim=-1)
            return ocfg.b2 * vr + (1 - ocfg.b2) * g * g

        def upd_vc(g, vc):
            if factored(g, vc):
                return ocfg.b2 * vc + (1 - ocfg.b2) * torch.mean(g * g,
                                                                 dim=-2)
            return vc

        vr = tree_map(upd_vr, grads, state["vr"], state["vc"])
        vc = tree_map(upd_vc, grads, state["vc"])

        def precond(g, vr_, vc_):
            if factored(g, vc_):
                r = vr_ / torch.clamp(torch.mean(vr_, dim=-1, keepdim=True),
                                      min=1e-30)
                vhat = r[..., None] * vc_[..., None, :]
                return g / (torch.sqrt(vhat / d) + ocfg.eps)
            return g / (torch.sqrt(vr_ / d) + ocfg.eps)

        upd = tree_map(precond, grads, vr, vc)
        m = tree_map(lambda mq, u: _q8(ocfg.b1 * _dq8(mq)
                                       + (1 - ocfg.b1) * u),
                     state["m"], upd)
        upd = tree_map(_dq8, m)
        new_state = {"step": step, "m": m, "vr": vr, "vc": vc}
    else:
        raise ValueError(ocfg.name)
    new_params = tree_map(upd_param, params, upd)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
