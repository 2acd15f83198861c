"""DTensor sharding strategies the sharded train step needs beyond those
torch registers.

The token-LM train step runs SPMD on DTensors (``launch/steps.py``), and
an op with no sharding strategy raises: nothing falls back to a gathered
or one-rank step.  Four ops of the forward and backward have strategies
in some torch releases that raise, or give a wrong local shape, where
the op is well defined.  ``register`` gives each one here, with the same
arithmetic on the local tensors; ``runtime/elastic.py`` calls it before
it makes the first DTensor, so that nothing changes DTensor's tables in
a process that places no state on a mesh of ranks.  The strategies lean
on DTensor's private modules and were checked against the releases in
``CHECKED``: ``register`` raises on any other.

* ``aten.view`` and ``aten._unsafe_view``, the reshapes inside
  ``einsum``, ``matmul`` and ``reshape``: strict views in DTensor.  Two
  cases take ``reshape``'s strategy (the input redistributed first, the
  result a copy, not an alias; the models take such views only of
  temporaries, and none writes into one):
  - a view that flattens a dimension sharded after the first of its
    group (the attention's heads over ``model`` beside the batch over
    ``data``), which 2.11's strict rule refuses;
  - a view that splits a dimension sharded over two mesh axes, whose
    local shape DTensor gets wrong (2.11 and 2.13: the MoE's token groups
    over a batch split on ``data`` and ``model``, "shape [1, 64, 8] is
    invalid"); the dimension is sharded over its first axis only.
  Any other refusal of the strict rule raises.
* ``aten.constant_pad_nd`` (``F.pad``, the causal convolutions of xLSTM
  and Mamba2): one placement whatever the mesh's dimensions in 2.11.
  Here: a padded or partial dimension's mesh axes replicated, every other
  placement kept.
* ``aten.index_put`` with ``accumulate`` (the backward of indexing a table
  by a tensor of indices, the embedding's): 2.11's strategy assumes the
  values have no more dimensions than the table and writes ``Shard(-1)``
  for a batch of token rows.  Here, when the values have more: the
  indices and the values' index dimensions replicated, each trailing
  dimension placed as the table's matching one.  Any other case keeps
  torch's own strategy.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._dtensor_spec import DTensorSpec
from torch.distributed.tensor._op_schema import (OpSchema, OpSpec,
                                                  OpStrategy,
                                                  RuntimeSchemaInfo)
from torch.distributed.tensor._ops._view_ops import (Flatten, Repeat, Split,
                                                     register_op_strategy_map,
                                                     view_groups)
from torch.distributed.tensor._ops.utils import (generate_redistribute_costs,
                                                 register_op_strategy)

aten = torch.ops.aten
CHECKED = ("2.11", "2.13")  # the torch releases these strategies were held to
_registered = False
_torch_index_put = None  # torch's own strategy, kept by ``register``


def register() -> None:
    """Register the strategies, once a process.  Raises on a torch release
    not in ``CHECKED``."""
    global _registered, _torch_index_put
    if _registered:
        return
    release = ".".join(torch.__version__.split("+")[0].split(".")[:2])
    if release not in CHECKED:
        raise RuntimeError(f"distributed/dtensor_ops.py: DTensor strategies "
                           f"checked against torch {CHECKED}, not "
                           f"{torch.__version__}")
    _view_strategy(aten.view.default)
    _view_strategy(aten._unsafe_view.default)
    register_op_strategy(aten.constant_pad_nd.default,
                         schema_info=RuntimeSchemaInfo(1))(_pad_strategy)
    _torch_index_put = DTensor._op_dispatcher.sharding_propagator \
        .op_strategy_funcs.get(aten.index_put.default)
    register_op_strategy(
        [aten.index_put.default, aten._index_put_impl_.default],
        schema_info=RuntimeSchemaInfo(needs_pytree=True))(
            _index_put_strategy)
    _registered = True


def _spec(mesh, placements, like: DTensorSpec | None = None) -> DTensorSpec:
    return DTensorSpec(mesh, tuple(placements),
                       tensor_meta=like.tensor_meta if like else None)


def _once_a_dim(placements) -> list:
    """``placements`` with each tensor dimension sharded over its first
    mesh axis only (later axes that shard it again replicated)."""
    seen, out = set(), []
    for p in placements:
        if type(p) is Shard and p.dim in seen:
            p = Replicate()
        elif type(p) is Shard:
            seen.add(p.dim)
        out.append(p)
    return out


def _reshapes_split_dim(src: DTensorSpec, shape) -> bool:
    """Whether a view of ``src`` to ``shape`` changes the leading
    dimensions up to one that is sharded over two mesh axes."""
    old = tuple(src.shape)
    shape = list(shape)
    if -1 in shape:
        rest = math.prod(n for n in shape if n != -1)
        shape[shape.index(-1)] = math.prod(old) // max(rest, 1)
    twice = [p.dim for p in src.placements if type(p) is Shard]
    twice = {d for d in twice if twice.count(d) > 1}
    return any(old[:d + 1] != tuple(shape[:d + 1]) for d in twice)


def _flattens_later_dim(src: DTensorSpec, shape) -> bool:
    """Whether a view of ``src`` to ``shape`` flattens a group of
    dimensions in which one after the first is sharded."""
    sharded = {p.dim for p in src.placements if type(p) is Shard}

    def walk(cmd) -> bool:
        if isinstance(cmd, Flatten):
            return any(d.input_dim in sharded for d in cmd.input_dims[1:]) \
                or any(walk(d) for d in cmd.input_dims)
        if isinstance(cmd, (Split, Repeat)):
            return walk(cmd.input_dim)
        return False

    return any(walk(cmd) for cmd in view_groups(tuple(src.shape),
                                                tuple(shape)))


def _view_strategy(op) -> None:
    """``op``'s strict strategy; ``reshape``'s where the view splits a
    dimension sharded over two mesh axes (whose local shape DTensor gets
    wrong), on that dimension sharded once, or where the strict rule
    refuses to flatten a dimension sharded after the first of its group;
    any other refusal raises."""
    funcs = DTensor._op_dispatcher.sharding_propagator.op_strategy_funcs
    own = funcs[op]
    register_op_strategy_map(op, torch.Tensor.view,
                             schema_info=RuntimeSchemaInfo(1))
    loose = funcs[op]

    @register_op_strategy(op, schema_info=RuntimeSchemaInfo(1))
    def strategy(op_schema):
        inp, shape = op_schema.args_schema[0], op_schema.args_schema[1]
        if any(_reshapes_split_dim(s.output_spec, shape)
               for s in inp.strategies):
            once = OpStrategy([OpSpec(_spec(
                s.output_spec.mesh, _once_a_dim(s.output_spec.placements),
                s.output_spec)) for s in inp.strategies])
            out = loose(OpSchema(op_schema.op, (once, *op_schema.args_schema[
                1:]), op_schema.kwargs_schema, op_schema.schema_info))
            for spec in out.strategies:
                spec.redistribute_cost = [generate_redistribute_costs(
                    inp, spec.input_specs[0])]
            return out
        try:
            return own(op_schema)
        except RuntimeError:
            if not any(_flattens_later_dim(s.output_spec, shape)
                       for s in inp.strategies):
                raise
            return loose(op_schema)


def _pad_strategy(op_schema) -> OpStrategy:
    inp, pad = op_schema.args_schema[0], op_schema.args_schema[1]
    padded = {inp.ndim - 1 - i for i in range(len(pad) // 2)
              if pad[2 * i] or pad[2 * i + 1]}
    out = OpStrategy([])
    for s in inp.strategies:
        src = s.output_spec
        tgt = [Replicate() if p.is_partial() or (
            isinstance(p, Shard) and p.dim in padded) else p
            for p in src.placements]
        tgt_spec = _spec(src.mesh, tgt, src)
        out.strategies.append(OpSpec(
            output_specs=_spec(src.mesh, tgt), input_specs=(tgt_spec,),
            redistribute_cost=[generate_redistribute_costs(inp, tgt_spec)]))
    return out


def _index_put_strategy(op_schema):
    table, indices, values, *_ = op_schema.args_schema
    n_idx = len(indices.children)
    trailing = table.ndim - n_idx
    lead = values.ndim - trailing  # the values' index dimensions
    if lead <= n_idx or any(c is None for c in indices.children):
        return _torch_index_put(op_schema)
    mesh = values.mesh
    idx_specs = [_spec(mesh, [Replicate()] * mesh.ndim,
                       c.strategies[0].output_spec)
                 for c in indices.children]
    idx_costs = [generate_redistribute_costs(c, s)
                 for c, s in zip(indices.children, idx_specs)]
    out = OpStrategy([])
    for exemplar, offset in ((table, n_idx), (values, lead)):
        for s in exemplar.strategies:
            t_pl, v_pl = [], []
            for p in s.output_spec.placements:
                if isinstance(p, Shard) and p.dim >= offset:
                    t_pl.append(Shard(p.dim - offset + n_idx))
                    v_pl.append(Shard(p.dim - offset + lead))
                else:
                    t_pl.append(Replicate())
                    v_pl.append(Replicate())
            t_spec = _spec(mesh, t_pl, table.strategies[0].output_spec)
            v_spec = _spec(mesh, v_pl, values.strategies[0].output_spec)
            out.strategies.append(OpSpec(
                output_specs=_spec(mesh, t_pl,
                                   table.strategies[0].output_spec),
                input_specs=(t_spec, *idx_specs, v_spec),
                redistribute_cost=[
                    generate_redistribute_costs(table, t_spec), *idx_costs,
                    generate_redistribute_costs(values, v_spec)]))
    return out
