"""Kernel B4's launch plan (``csrc/halo_exchange.cu``) walked on the CPU.

``plan`` below follows the kernel's launch with the source's own constants
(read from the ``.cu``): the vector (``halo.vec_width``: 16 bytes when a
pair is whole 16-byte units and every pointer is aligned, else one
element), the tile, the grid (tiles, n, n) with blockIdx.z the
schedule's step and blockIdx.y the sender, and what each block's threads
load and store. Every recv byte must be written
exactly once, no read may leave its send and no write its recv, 16-byte
vectors must sit at 16-byte offsets, no tile may cross a pair and every
tile of a pair but its last must be full, and the pairs must come in
``step_offsets`` order. The copies must give ``halo_exchange_plain``'s
result and, on a few shapes, the JAX ``pallas_halo_exchange``'s
(interpreted on the CPU mesh).

Inputs come from ``np.random.default_rng``; every comparison is exact.
"""

import re
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from primekg_rgcn_tpu.ops.pallas.halo import pallas_halo_exchange
from primekg_rgcn_tpu.parallel.mesh import make_mesh as j_mesh
from primekg_rgcn_tpu_torch.ops.cuda import halo

SOURCE = (Path(halo.__file__).resolve().parents[2] / "csrc" /
          "halo_exchange.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


TILE = (_const("kThreads"), _const("kUnroll"))
# (P, D) for every dtype: empty, one row, odd widths, and pairs of a few
# thousand rows that are not a multiple of the tile.
SHAPES = ([(p, d) for p in (0, 1, 7) for d in (1, 3, 64, 128)]
          + [(2000, d) for d in (1, 3, 64)])


def plan(n, p, d, elt, ptrs):
    """The kernel's launch for an n-shard [n, P, D] exchange of
    ``elt``-byte elements at addresses ``ptrs``: the vector and each
    block's copy as rows (step, sender, peer, tile index, send byte
    offset, recv byte offset, bytes), in the grid's order (z, y, x)."""
    vec = halo.vec_width(p, d, elt, ptrs)
    pair_vecs = p * d // vec
    threads, unroll = TILE
    per_block = threads * unroll
    tiles = -(-pair_vecs // per_block)
    # Thread t of a block loads and stores vectors t + u * threads of its
    # tile: one contiguous run of the tile's vectors, each once.
    own = (np.arange(threads)[None, :]
           + threads * np.arange(unroll)[:, None]).ravel()
    assert (np.sort(own) == np.arange(per_block)).all()
    x = np.arange(tiles)
    first = x * per_block  # the tile's first vector; the guard j < P*D/vec
    count = np.minimum(per_block, pair_vecs - first)  # cuts the last
    offsets = halo.step_offsets(n)
    vbytes = vec * elt
    rows = []
    for step in range(n):          # blockIdx.z
        for s in range(n):         # blockIdx.y
            peer = (s + offsets[step]) % n
            rows.append(np.stack([
                np.full(tiles, step), np.full(tiles, s), np.full(tiles, peer),
                x, (peer * pair_vecs + first) * vbytes,
                (s * pair_vecs + first) * vbytes, count * vbytes], 1))
    blocks = np.concatenate(rows) if tiles else np.zeros((0, 7), np.int64)
    return vec, blocks


def check_plan(n, p, d, elt, ptrs):
    """``plan``'s invariants at one shape. Returns the vector and the
    blocks."""
    vec, blocks = plan(n, p, d, elt, ptrs)
    threads, unroll = TILE
    step, s, peer, x, src, dst, nbytes = blocks.T
    pair_bytes = p * d * elt
    tile_bytes = threads * unroll * vec * elt
    offsets = np.asarray(halo.step_offsets(n))
    assert ((0 < nbytes) & (nbytes <= tile_bytes)).all()
    assert (peer == (s + offsets[step]) % n).all()
    # No tile crosses a pair: it stays in block `peer` of send[s] and block
    # `s` of recv[peer].
    assert ((peer * pair_bytes <= src)
            & (src + nbytes <= (peer + 1) * pair_bytes)).all()
    assert ((s * pair_bytes <= dst) & (dst + nbytes <= (s + 1) * pair_bytes)).all()
    assert (src % (vec * elt) == 0).all() and (dst % (vec * elt) == 0).all()
    if vec > 1:
        assert not ((src | dst | nbytes) % 16).any()
    for o in range(n):  # recv o's runs tile [0, n * pair_bytes): each once
        order = np.argsort(dst[peer == o])
        start, size = dst[peer == o][order], nbytes[peer == o][order]
        assert (np.concatenate([[0], start + size]) ==
                np.concatenate([start, [n * pair_bytes]])).all()
    tiles = x.max() + 1 if len(x) else 0
    assert (nbytes[x < tiles - 1] == tile_bytes).all()  # full but the last
    # In the grid's order the pairs come step by step, as step_offsets
    # gives them, every pair once.
    key = step * n + s
    assert (np.diff(key) >= 0).all()
    assert len(np.unique(key)) == (n * n if pair_bytes else 0)
    return vec, blocks


def run_plan(sends, ptrs):
    """The exchange as ``plan``'s blocks copy it, on byte views."""
    n, p, d = sends[0].shape
    elt = sends[0].element_size()
    src = [s.contiguous().view(torch.uint8).reshape(-1).numpy()
           for s in sends]
    out = [np.full(n * p * d * elt, 0xA5, np.uint8) for _ in range(n)]
    _, blocks = check_plan(n, p, d, elt, ptrs)
    for _, s, peer, _, so, ro, nbytes in blocks:
        out[peer][ro:ro + nbytes] = src[s][so:so + nbytes]
    return [torch.from_numpy(o).view(sends[0].dtype).reshape(n, p, d)
            for o in out]


def _sends(n, p, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(n, p, d)).astype(np.float32))
            .to(dtype) for _ in range(n)]


ALIGNED = [0, 4096, 1 << 20, 3 << 20]  # 16-byte aligned sends and recvs
MISALIGNED = [4, 4096, 1 << 20, 3 << 20]  # one send 4 bytes off


def test_source_constants():
    """The tile is whole warps, and 16 KB of 16-byte vectors."""
    assert TILE[0] % 32 == 0
    assert TILE[0] * TILE[1] * 16 == 16 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", range(1, 9))
def test_plan_writes_each_recv_byte_once(n, dtype):
    """At every shape, aligned and misaligned: ``check_plan``'s
    invariants, and the copies equal ``halo_exchange_plain``."""
    elt = torch.empty((), dtype=dtype).element_size()
    paths = set()
    for p, d in SHAPES:
        if not p * d:
            assert len(plan(n, p, d, elt, ALIGNED)[1]) == 0
            continue
        sends = _sends(n, p, d, dtype, seed=n)
        want = halo.halo_exchange_plain(sends)
        for ptrs in (ALIGNED, MISALIGNED):
            paths.add(plan(n, p, d, elt, ptrs)[0] > 1)
            for got, w in zip(run_plan(sends, ptrs), want):
                assert torch.equal(got, w)
    assert paths == {False, True}


def test_node_step_shapes_take_16_byte_vectors():
    """The node step's six exchanges (the bench.py graph's P = 7,736 at
    D = 64 and 128 in float32 and bf16, config 3's P = 31,856 in float32)
    all run 16-byte vectors, in 16 KB blocks: 3,872 of them at the
    bench.py graph's float32 D = 128."""
    blocks = {}
    for p, d, elt in [(7736, 64, 4), (7736, 128, 4), (7736, 64, 2),
                      (7736, 128, 2), (31856, 64, 4), (31856, 128, 4)]:
        vec, blocks[p, d, elt] = check_plan(4, p, d, elt, ALIGNED)
        assert vec == 16 // elt
        assert len(blocks[p, d, elt]) == 16 * -(-p * d * elt // (16 * 1024))
    assert len(blocks[7736, 128, 4]) == 3872


def test_vec_width_chooses_by_shape_and_alignment():
    f32, bf16 = 4, 2
    assert halo.vec_width(7736, 64, f32, [0, 256, 4096]) == 4
    assert halo.vec_width(4, 3, f32, [0, 16]) == 4     # 48 bytes a pair
    assert halo.vec_width(1, 3, f32, [0, 16]) == 1     # 12 bytes a pair
    assert halo.vec_width(7736, 64, f32, [0, 4]) == 1  # offset by 4 bytes
    assert halo.vec_width(1, 8, bf16, [32, 48]) == 8
    assert halo.vec_width(3, 3, bf16, [0, 16]) == 1
    assert halo.vec_width(16, 37, bf16, [0, 16]) == 8  # odd D, whole units
    assert halo.vec_width(7736, 64, bf16, [4, 16]) == 1


def _jax_pallas(send):
    n = send.shape[0]

    @jax.jit
    @partial(jax.shard_map, mesh=j_mesh(n), in_specs=P("data"),
             out_specs=P("data"), check_vma=False)
    def run(s):
        return pallas_halo_exchange(s[0], "data")[None]

    return np.asarray(run(jnp.asarray(send)))


@pytest.mark.parametrize("n, p, d, dtype", [
    (2, 7, 64, torch.float32), (4, 12, 8, torch.bfloat16),
    (8, 5, 16, torch.float32)])
def test_plan_equals_the_pallas_kernel(n, p, d, dtype):
    """The kernel's copies against the JAX Pallas kernel (interpret mode
    on the CPU mesh) and the plain version, bit for bit."""
    sends = _sends(n, p, d, dtype, seed=7)
    got = run_plan(sends, ALIGNED)
    for g, w in zip(got, halo.halo_exchange_plain(sends)):
        assert torch.equal(g, w)
    as_np = (lambda t: t.float().numpy()) if dtype == torch.bfloat16 else \
        (lambda t: t.numpy())
    send = np.stack([as_np(s) for s in sends])
    if dtype == torch.bfloat16:
        send = send.astype(jnp.bfloat16)
    want = _jax_pallas(send)
    np.testing.assert_array_equal(np.stack([as_np(g) for g in got]),
                                  np.asarray(want, np.float32))
