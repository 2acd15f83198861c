"""Checkpoints with a background save, atomic commit and garbage
collection, in the reference's on-disk layout.

Layout: <dir>/step_<n>/
  manifest.json          — ``step``, ``leaves`` (flattened key -> {shape,
                           dtype}), ``process_count``
  shard_<process>.npz    — this process's leaves

A tree is a nest of dicts, tuples and ``NamedTuple``s (``LIFParams``)
over tensors, numpy arrays or Python numbers.  Leaves are keyed as
``jax.tree_util.keystr`` keys them: dict keys sorted, ``['name']`` for a
dict key, ``[i]`` for a sequence index, ``.field`` for a ``NamedTuple``
field (``['params']['lif0'].raw_beta``), so a checkpoint written by either
package restores in the other.  ``save`` copies every leaf to the host
before it returns, then writes on a background thread into a temporary
directory that one rename commits: a save that dies leaves the latest
checkpoint whole.  ``restore`` puts each leaf on its template leaf's device
with its dtype; ``restore_into`` copies each leaf into a tree of tensors
in place.  bfloat16 leaves are written as the reference writes them (two
raw bytes an element, ``bfloat16`` in the manifest).
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(key, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``'s
    order, keyed as ``keystr`` writes them."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(template, it):
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], it) for k in sorted(template)}
        return {k: out[k] for k in template}  # the template's key order
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(x, it) for x in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(x, it) for x in template)
    return next(it)


# bfloat16 leaves are stored as the reference stores its numpy bfloat16
# arrays: two raw bytes an element (``|V2`` in the archive), ``bfloat16`` in
# the manifest
_BF16 = np.dtype("V2")


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (a CPU tensor's ``numpy()`` would share its
    memory)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().copy().view(_BF16)
    return np.array(leaf)


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == _BF16 else str(a.dtype)


def _from_host(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``a`` as a tensor of ``like``'s dtype, on the CPU."""
    if a.dtype == _BF16:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(like.dtype)


def _process() -> tuple[int, int]:
    """(this process's index, the process count)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ----------------------------------------------------------- save ----
    def save(self, step: int, tree, blocking: bool = False) -> None:
        # snapshot to the host BEFORE returning: the caller may go on to
        # update the tensors in place
        host = [(k, _to_host(v)) for k, v in _flatten(tree)]
        self.wait()
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, host), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write_guarded(self, step: int, host: list) -> None:
        try:
            self._write(step, host)
        except Exception as e:  # raised again by wait()
            self._error = e

    def _write(self, step: int, host: list) -> None:
        rank, count = _process()
        tmp = self.dir / f".tmp_step_{step}_{time.time_ns()}"
        tmp.mkdir(parents=True)
        manifest = {k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
                    for k, v in host}
        (tmp / "manifest.json").write_text(json.dumps({
            "step": step, "leaves": manifest, "process_count": count}))
        np.savez(tmp / f"shard_{rank}.npz", **dict(host))
        final = self.dir / f"step_{step}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic commit
        self._gc()

    def wait(self) -> None:
        """Join the background write; a write that failed raises here."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -------------------------------------------------------- restore ----
    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*"))

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template, step: int | None = None):
        """The checkpoint at ``step`` (default the latest) in
        ``template``'s structure, each leaf a tensor on its template
        tensor's device with its dtype.  Returns (tree, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with self._open(step) as data:
            leaves = [_from_host(data[k], t).to(t.device)
                      for k, t in _flatten(template)]
        return _unflatten(template, iter(leaves)), step

    def restore_into(self, tree, step: int | None = None) -> int:
        """The checkpoint at ``step`` (default the latest) copied into the
        tensors of ``tree`` in place, one leaf at a time, so that restoring
        a state holds one copy of it on its device and one leaf on the
        host.  A stored leaf whose shape is not its tensor's raises
        ``ValueError`` (``copy_`` would broadcast it).  Returns the step."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with torch.no_grad(), self._open(step) as data:
            for k, t in _flatten(tree):
                if tuple(data[k].shape) != tuple(t.shape):
                    raise ValueError(f"checkpoint leaf {k} has shape "
                                     f"{tuple(data[k].shape)}, the tree's "
                                     f"{tuple(t.shape)}")
                t.copy_(_from_host(data[k], t))
        return step

    def _open(self, step: int):
        rank, _ = _process()
        return np.load(self.dir / f"step_{step}" / f"shard_{rank}.npz")
