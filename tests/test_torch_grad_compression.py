"""The port's int8 gradient codec with error feedback
(``distributed/compression.py``) against the reference's.

q and scale must equal the reference's bit for bit (both round half to
even, and divide as IEEE float32 / bf16 does); the residual and the
dequantized gradients within ``RES_ATOL``.  ``compressed_psum`` runs over
a ``gloo`` process group: at world size 1 in this process (a
``HashStore``), and at two ranks in two ``sys.executable -c`` processes
over a ``FileStore`` (loopback only), held against the sum of the
reference's ``dequantize_leaf(quantize_leaf(x_r))`` within
``PSUM_RTOL``.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.distributed import compression as j_gc
from repro_torch.core.tree import tree_leaves, tree_leaves_with_path
from repro_torch.distributed import compression as gc

ROOT = Path(__file__).resolve().parents[1]
RES_ATOL = 1e-6  # residual and dequantized values against the reference's
PSUM_RTOL = 1e-6  # compressed_psum against the reference's codec, summed
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def seeded(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return np.asarray(np.random.default_rng(seed).standard_normal(shape)
                      * scale, dtype=np.float32)


def both(x: np.ndarray, dtype: str):
    t, j = DTYPES[dtype]
    return torch.from_numpy(x).to(t), jnp.asarray(x).astype(j)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seed,shape,scale", [
    (0, (64, 64), 1.0), (1, (3, 129), 1e-3), (2, (7,), 40.0),
    (3, (2, 16, 33), 1e-8), (4, (), 0.5)])
def test_quantize_leaf_bit_equal(dtype, seed, shape, scale):
    g, jg = both(seeded(seed, shape, scale), dtype)
    q, s = gc.quantize_leaf(g)
    jq, js = j_gc.quantize_leaf(jg)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js) and s.shape == ()
    np.testing.assert_array_equal(gc.dequantize_leaf(q, s).numpy(),
                                  np.asarray(j_gc.dequantize_leaf(jq, js)))


def test_quantize_leaf_zero_and_ties():
    """An all-zero leaf takes the 1e-12 floor; halves round to even."""
    for dtype in DTYPES:
        g, jg = both(np.zeros((4, 4), np.float32), dtype)
        q, s = gc.quantize_leaf(g)
        jq, js = j_gc.quantize_leaf(jg)
        assert not q.any() and s.item() == float(js)
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5], np.float32)
    q, _ = gc.quantize_leaf(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(
        j_gc.quantize_leaf(jnp.asarray(x))[0]))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, 126]


def grad_tree(dtype: str, seed: int = 7):
    xs = [seeded(seed + i, shape, scale) for i, (shape, scale) in enumerate(
        [((32, 48), 1e-2), ((48,), 1.0), ((4, 8, 16), 3e-5), ((1,), 2.0)])]
    pairs = [both(x, dtype) for x in xs]
    tree = {"w": pairs[0][0], "b": [pairs[1][0], {"k": pairs[2][0]}],
            "s": pairs[3][0]}
    j_tree = {"w": pairs[0][1], "b": [pairs[1][1], {"k": pairs[2][1]}],
              "s": pairs[3][1]}
    return tree, j_tree


def by_path(tree) -> dict:
    return {p: as_np(x) for p, x in tree_leaves_with_path(tree)}


def j_by_path(tree) -> dict:
    import jax

    return {jax.tree_util.keystr(p): as_np(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_compress_grads_equals_reference(dtype):
    """Two steps of error feedback: q and scale bit-equal, the residual
    and the decompressed gradients within ``RES_ATOL``."""
    tree, j_tree = grad_tree(dtype)
    res, j_res = gc.init_error_feedback(tree), j_gc.init_error_feedback(j_tree)
    assert all(r.dtype == torch.float32 and not r.any()
               for r in tree_leaves(res))
    for _ in range(2):
        comp, res = gc.compress_grads(tree, res)
        j_comp, j_res = j_gc.compress_grads(j_tree, j_res)
        got, want = by_path(comp), j_by_path(j_comp)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        got, want = by_path(res), j_by_path(j_res)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=RES_ATOL, err_msg=k)
        got = by_path(gc.decompress_grads(comp))
        want = j_by_path(j_gc.decompress_grads(j_comp))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=RES_ATOL, err_msg=k)


def test_reference_error_feedback_assertions():
    """``tests/test_distributed.py:75-91``'s three assertions, on the
    port."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 64)).astype(np.float32))}
    res = gc.init_error_feedback(g)
    comp, res2 = gc.compress_grads(g, res)
    back = gc.decompress_grads(comp)
    rel = float(torch.linalg.norm(back["w"] - g["w"])
                / torch.linalg.norm(g["w"]))
    assert rel < 0.02
    np.testing.assert_allclose(res2["w"].numpy(),
                               (g["w"] - back["w"]).numpy(), atol=1e-6)
    comp2, res3 = gc.compress_grads(g, res2)
    back2 = gc.decompress_grads(comp2)
    total = back["w"] + back2["w"]
    rel2 = float(torch.linalg.norm(total - 2 * g["w"])
                 / torch.linalg.norm(2 * g["w"]))
    assert rel2 < rel


# ------------------------------------------------------- compressed_psum


def test_compressed_psum_raises_without_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        gc.compressed_psum(torch.ones(4))


def test_compressed_psum_one_rank(monkeypatch):
    """World size 1 (gloo, ``HashStore``): the leaf's own codec round
    trip, bit for bit, and the reference's."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        for dtype in DTYPES:
            x, jx = both(seeded(11, (16, 40)), dtype)
            got = gc.compressed_psum(x)
            assert got.dtype == torch.float32
            assert torch.equal(got, gc.dequantize_leaf(*gc.quantize_leaf(x)))
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(j_gc.dequantize_leaf(
                    *j_gc.quantize_leaf(jx))))
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.elastic import per_host_batch

    torch.set_num_threads(1)
    rank, world, store_path, out = int(sys.argv[1]), 2, sys.argv[2], sys.argv[3]
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world)
    try:
        rng = np.random.default_rng(100 + rank)
        x = torch.from_numpy((rng.standard_normal((24, 40))
                              * (1 + rank)).astype(np.float32))
        got = compressed_psum(x)
        xb = x.to(torch.bfloat16)
        got_b = compressed_psum(xb)
        mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
        np.savez(out, f32=got.numpy(), bf16=got_b.numpy(),
                 host_batch=per_host_batch(64, mesh))
    finally:
        dist.destroy_process_group()
""")


def test_compressed_psum_two_ranks(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1"}
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(store),
         str(tmp_path / f"rank{r}.npz")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:  # a rank left waiting on the other after a timeout
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    outs = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    xs = [(np.random.default_rng(100 + r).standard_normal((24, 40))
           * (1 + r)).astype(np.float32) for r in range(2)]
    for key, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        want = sum(np.asarray(j_gc.dequantize_leaf(*j_gc.quantize_leaf(
            jnp.asarray(x).astype(jdt)))) for x in xs)
        for out in outs:
            np.testing.assert_allclose(out[key], want, rtol=PSUM_RTOL,
                                       atol=0)
        np.testing.assert_array_equal(outs[0][key], outs[1][key])
    # the world size, not the data axes, divides the global batch
    assert [int(o["host_batch"]) for o in outs] == [32, 32]
