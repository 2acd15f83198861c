"""What a step costs, counted op by op as it runs: FLOPs, eager memory
traffic, peak live bytes and the number of ops.

The port's counterpart of the reference's ``analysis/hlo.py`` ``analyze``,
which reads the same figures from XLA's optimized HLO text.  A PyTorch
program has no such text, so ``OpCost`` is one ``TorchDispatchMode``
around the step: every aten op the step dispatches, forward and backward,
passes through it once.  The step may run on ``meta`` tensors (shapes
only, nothing computed: the dry run) or on a real device; the same
program gives the same counts on both.

  * ``flops``: matmuls, convolutions and attention by
    ``torch.utils.flop_counter``'s formulas (``flop_registry``; an op it
    has no formula for is decomposed first, as ``FlopCounterMode`` does),
    plus, as ``hlo.py`` counts them, one FLOP per output element of each
    arithmetic elementwise op (``ELEMENTWISE``: ``hlo.py``'s
    ``_ELEMENTWISE`` under aten's names, and a few composite aten ops at
    the number of those they stand for);
  * ``hbm_bytes``: the input plus output bytes of every op that is not a
    view or alias, a factory (no tensor input) or a metadata query.  The
    port runs eagerly and fuses nothing, so this is the eager program's
    own traffic, where ``hlo.py`` counts the traffic of XLA's fusions;
  * ``peak_bytes``: the peak of live bytes of the storages the step
    allocates (each op output that aliases none of its inputs), beyond
    what existed before: a storage counts from the op that makes it until
    it is freed.  On ``meta`` this is the only memory figure there is;
  * ``ops``: the ops counted, standing in for ``num_computations``.

``by_op`` holds, for each aten op (its overload packet's name), the
calls, FLOPs and bytes, so that two runs can be compared op by op.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# hlo.py's _ELEMENTWISE under aten's names (an in-place variant, ``add_``,
# counts as its op): add, subtract, multiply, divide, power, exponential,
# tanh, log, negate, maximum, minimum, compare, select, rsqrt, sqrt,
# and/or/xor, convert (a copy that changes the dtype), floor, ceil, abs,
# sign, cosine, sine, logistic, expm1, log-plus-one, atan2, remainder,
# clamp; then composite aten ops at the count of those they lower to.
ELEMENTWISE = {
    **dict.fromkeys((
        "add", "sub", "rsub", "mul", "div", "pow", "exp", "tanh", "log",
        "neg", "maximum", "minimum", "eq", "ne", "lt", "le", "gt", "ge",
        "where", "rsqrt", "sqrt", "logical_and", "logical_or", "logical_xor",
        "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
        "bitwise_not", "floor", "ceil", "round", "abs", "sign", "cos", "sin",
        "sigmoid", "expm1", "log1p", "atan2", "remainder", "fmod", "clamp",
        "clamp_min", "clamp_max", "reciprocal", "square"), 1),
    "silu": 2,  # logistic, multiply
    "addcmul": 2, "addcdiv": 2, "lerp": 2,  # multiply (divide), add
    "_softmax": 3, "_log_softmax": 3,  # subtract, exponential, divide / log
    "logaddexp": 4,  # maximum, subtract, exponential, log-plus-one (+add)
    "softplus": 3,
    "sigmoid_backward": 3, "tanh_backward": 3, "silu_backward": 5,
    "_softmax_backward_data": 3, "_log_softmax_backward_data": 3,
    "threshold_backward": 2,
}
_CONVERTS = {"_to_copy", "copy"}  # count one FLOP an element when the
# dtype changes (hlo.py's ``convert``)


def _tensors(items) -> list:
    """The tensors among an op's arguments or results: tensors, and lists
    or tuples of them (an aten schema nests no deeper)."""
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ops that have no decomposition (filled as the ops are met)
_ATOMIC: set = {torch.ops.prim.device.default}


class OpCost(TorchDispatchMode):
    """Count the ops dispatched while the mode is on (``with OpCost() as
    c: step(...)``); then ``c.result()``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.ops = 0
        self.by_op: dict[str, list] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: set[int] = set()  # keys of the storages counted

    def _freed(self, key: int, n: int) -> None:
        self._live.discard(key)
        self.live_bytes -= n

    def _track(self, out: list, in_keys: set) -> None:
        for t in out:
            s = t.untyped_storage()
            key = s._cdata
            if key in in_keys or key in self._live:
                continue
            n = s.nbytes()
            self._live.add(key)
            self.live_bytes += n
            # the storage's Python object lives exactly as long as the
            # storage (PyTorch preserves it), views and tensors autograd
            # saved included
            weakref.finalize(s, self._freed, key, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if func not in _ATOMIC and packet not in flop_registry:
            with self:  # the decomposition's ops counted one by one
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            _ATOMIC.add(func)
        result = func(*args, **kwargs)
        out = _tensors(result if isinstance(result, (list, tuple))
                       else (result,))
        if not out:  # a metadata query or a scalar read
            return result
        ins = _tensors(args)
        if kwargs:
            ins += _tensors(kwargs.values())
        in_keys = {t.untyped_storage()._cdata for t in ins}
        self._track(out, in_keys)
        name = packet.__name__
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=result)
        else:
            base = name[:-1] if name.endswith("_") else name
            per = ELEMENTWISE.get(base)
            if per is None and base in _CONVERTS and ins and \
                    ins[0].dtype != out[0].dtype:
                per = 1
            if per:
                flops = per * out[0].numel()
        aliasing = func.is_view or (
            not func._schema.is_mutable and all(
                t.untyped_storage()._cdata in in_keys for t in out))
        factory = not ins or name.endswith("_like") or \
            name.startswith("new_")  # reads no input data
        nbytes = 0
        if not factory and not aliasing:
            nbytes = sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in out)
        self.ops += 1
        self.flops += flops
        self.hbm_bytes += nbytes
        rec = self.by_op.setdefault(name, [0, 0, 0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        return result

    def result(self) -> dict:
        """The counts: ``flops``, ``hbm_bytes``, ``peak_bytes`` (live at
        the peak), ``live_bytes`` (still live at the end: the outputs and
        anything they hold) and ``ops``."""
        return {"flops": float(self.flops), "hbm_bytes": float(self.hbm_bytes),
                "peak_bytes": self.peak_bytes, "live_bytes": self.live_bytes,
                "ops": self.ops}

