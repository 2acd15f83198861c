"""Optimizers: AdamW, AdamW with 8-bit states, Adafactor (+ int8 momentum).

Pure functions over a parameter tree: a dict of tensors whose ``lif*``
leaves are ``LIFParams`` (the RSNN's parameter dict), with optimizer state
of the same structure.  ``apply_updates`` returns new tensors and leaves
its inputs as they were; ``apply_updates_`` writes the same values into
the parameter and state tensors it is given (the reference's donated
state).  Both run under ``torch.no_grad()`` on the parameters' device.  The formulas are the reference's, in its order of
float operations, and every division by a constant divides by a tensor
on the operand's device (PyTorch divides a CUDA tensor by a host scalar as
a product with its reciprocal).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.core.tree import PartitionSpec as P


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


tree_leaves = functools.partial(tree_lib.tree_leaves, is_leaf=_is_leaf)
tree_unflatten = functools.partial(tree_lib.tree_unflatten, is_leaf=_is_leaf)
tree_map = functools.partial(tree_lib.tree_map, is_leaf=_is_leaf)


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


# the per-leaf state trees of each optimizer, in the state dict's order
_SLOTS = {"adamw": ("m", "v"), "adamw8bit": ("m", "v"),
          "adafactor": ("m", "vr", "vc")}


def _prologue(grads, state: dict, ocfg: OptimizerConfig):
    """The step's scalars: (step, lr, grad_norm, clip, bc1, bc2)."""
    if ocfg.name not in _SLOTS:
        raise ValueError(ocfg.name)
    step = state["step"] + 1
    lr = schedule(ocfg, step)
    gnorm = _global_norm(grads)
    clip = torch.clamp(torch.full_like(gnorm, ocfg.grad_clip)
                       / torch.clamp(gnorm, min=1e-12), max=1.0)
    t = step.to(torch.float32)
    return step, lr, gnorm, clip, 1.0 - ocfg.b1 ** t, 1.0 - ocfg.b2 ** t


def _update_leaf(ocfg: OptimizerConfig, p, g, slots: tuple, lr, clip, bc1,
                 bc2):
    """One parameter leaf's update: (new parameter, new slot leaves)."""
    g = g.to(torch.float32) * clip
    if ocfg.name == "adamw":
        m, v = slots
        m = ocfg.b1 * m + (1 - ocfg.b1) * g
        v = ocfg.b2 * v + (1 - ocfg.b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + ocfg.eps)
        new = (m, v)
    elif ocfg.name == "adamw8bit":
        mq, vq = slots
        mq = _q8(ocfg.b1 * _dq8(mq) + (1 - ocfg.b1) * g)
        vq = _q8log(ocfg.b2 * _dq8log(vq) + (1 - ocfg.b2) * g * g)
        u = (_dq8(mq) / bc1) / (torch.sqrt(_dq8log(vq) / bc2) + ocfg.eps)
        new = (mq, vq)
    else:  # adafactor; bc2 is its d = 1 - b2^t
        mq, vr, vc = slots
        factored = g.dim() >= 2 and vc.dim() > 0
        if factored:
            vr = ocfg.b2 * vr + (1 - ocfg.b2) * torch.mean(g * g, dim=-1)
            vc = ocfg.b2 * vc + (1 - ocfg.b2) * torch.mean(g * g, dim=-2)
            r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                 min=1e-30)
            vhat = r[..., None] * vc[..., None, :]
            u = g / (torch.sqrt(vhat / bc2) + ocfg.eps)
        else:
            vr = ocfg.b2 * vr + (1 - ocfg.b2) * g * g
            u = g / (torch.sqrt(vr / bc2) + ocfg.eps)
        mq = _q8(ocfg.b1 * _dq8(mq) + (1 - ocfg.b1) * u)
        u = _dq8(mq)
        new = (mq, vr, vc)
    wd = ocfg.weight_decay * p.to(torch.float32) if p.dim() >= 2 else 0.0
    return (p.to(torch.float32) - lr * (u + wd)).to(p.dtype), new


@torch.no_grad()
def apply_updates(params, grads, state: dict, ocfg: OptimizerConfig):
    """Returns (new_params, new_state, metrics: ``grad_norm``, ``lr``)."""
    step, lr, gnorm, clip, bc1, bc2 = _prologue(grads, state, ocfg)
    names = _SLOTS[ocfg.name]
    new_params, cols = [], [[] for _ in names]
    for p, g, *slots in zip(tree_leaves(params), tree_leaves(grads),
                            *(tree_leaves(state[n]) for n in names)):
        p, new = _update_leaf(ocfg, p, g, tuple(slots), lr, clip, bc1, bc2)
        new_params.append(p)
        for col, x in zip(cols, new):
            col.append(x)
    new_state = {"step": step}
    for n, col in zip(names, cols):
        new_state[n] = tree_unflatten(state[n], iter(col))
    return (tree_unflatten(params, iter(new_params)), new_state,
            {"grad_norm": gnorm, "lr": lr})


def _copy_leaf_(dst, src) -> None:
    if isinstance(dst, dict):  # an int8 codec
        for k in dst:
            dst[k].copy_(src[k])
    else:
        dst.copy_(src)


@torch.no_grad()
def apply_updates_(params, grads: list, state: dict, ocfg: OptimizerConfig):
    """``apply_updates`` in place, the port's counterpart of the
    reference's donated state: each parameter and optimizer-state leaf is
    overwritten with its new value, leaf by leaf after the global norm, so
    that at most one leaf's float32 temporaries are alive at once.
    ``grads`` is the list of gradient leaves in ``tree_leaves(params)``'s
    order; each entry is set to ``None`` once applied, freeing it if the
    caller holds no other reference.  Bit-equal to ``apply_updates`` (the
    same operations on each leaf).  Returns (params, state, metrics), the
    objects it was given."""
    step, lr, gnorm, clip, bc1, bc2 = _prologue(grads, state, ocfg)
    names = _SLOTS[ocfg.name]
    slot_leaves = [tree_leaves(state[n]) for n in names]
    for i, p in enumerate(tree_leaves(params)):
        slots = tuple(col[i] for col in slot_leaves)
        new_p, new = _update_leaf(ocfg, p, grads[i], slots, lr, clip, bc1,
                                  bc2)
        grads[i] = None
        p.copy_(new_p)
        del new_p
        for dst, src in zip(slots, new):
            _copy_leaf_(dst, src)
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# PartitionSpecs for optimizer state
# ---------------------------------------------------------------------------


def state_specs(param_specs, params_shapes, ocfg: OptimizerConfig) -> dict:
    """The specs of ``init_opt_state``'s tree from the parameters' specs
    (``distributed/sharding.py`` ``tree_param_specs``) and shapes (tensors,
    meta ones included): the reference's rules."""
    scalar = P()

    def drop_last(spec):
        return P(*tuple(spec)[:-1]) if len(tuple(spec)) else spec

    def drop_second_last(spec):
        t = tuple(spec)
        return P(*(t[:-2] + t[-1:])) if len(t) >= 2 else spec

    def q(spec):
        return {"q": spec, "scale": scalar}

    if ocfg.name == "adamw":
        return {"step": scalar, "m": param_specs, "v": param_specs}
    if ocfg.name == "adamw8bit":
        return {"step": scalar, "m": tree_lib.tree_map(q, param_specs),
                "v": tree_lib.tree_map(q, param_specs)}
    if ocfg.name == "adafactor":
        def vr_spec(spec, p):
            return drop_last(spec) if _spec_factored(p.shape) else spec

        def vc_spec(spec, p):
            return drop_second_last(spec) if _spec_factored(p.shape) \
                else scalar
        return {"step": scalar, "m": tree_lib.tree_map(q, param_specs),
                "vr": tree_lib.tree_map(vr_spec, param_specs, params_shapes),
                "vc": tree_lib.tree_map(vc_spec, param_specs, params_shapes)}
    raise ValueError(ocfg.name)


def _spec_factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128
