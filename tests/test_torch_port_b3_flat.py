"""Kernel B3's flat mapping (``csrc/window_fetch.cu``) walked on the CPU.

``emulate_b3`` below follows the kernel thread by thread, with the
source's own block size (read from the ``.cu``): thread c of the grid owns
chunk c, records 2c and 2c + 1; its first record finds its window by
division, the second the same window or, at a window's end, the next one
at offset 0; the chunk is written as one 16-byte store, the odd trailing
record alone. Every output record must be written exactly once, no read
may leave ``starts`` or the table, and the result must equal
``window_rows_fetch_plain``; on the granule-pairs table it must also equal
the JAX ``window_rows_fetch(impl="pallas")``, interpreted on the CPU.

Inputs come from ``np.random.default_rng``; every comparison is exact.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.data import sampling as js
from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.ops.pallas import window_fetch as jwf
from primekg_rgcn_tpu_torch.data import sampling as ps
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.ops.cuda import window_fetch as pwf

SOURCE = (Path(pwf.__file__).resolve().parents[2] / "csrc" /
          "window_fetch.cu").read_text()
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", SOURCE).group(1))
WIDTHS = (1, 3, 6, 8, 10, 12, 15, 24, 37, 40, 48, 64)


def emulate_b3(rows, starts, width):
    """``csrc/window_fetch.cu``, every thread of the grid at once. Returns
    the output [M, width, 2] and how often each output record was
    written."""
    m = starts.shape[0]
    total = m * width
    assert total < 2 ** 31
    max_start = rows.shape[0] - width
    chunks = (total + 1) // 2
    grid = -(-chunks // THREADS)
    out = np.full((total, 2), -1, np.int64)
    writes = np.zeros(total, np.int64)
    c = np.arange(grid * THREADS, dtype=np.uint32)
    r = 2 * c.astype(np.uint64)
    r = r[r < total]  # threads past the last chunk load and store nothing
    i = r // width
    j = r - i * width
    assert (i < m).all() and (j < width).all()
    pair = r + 1 < total  # the second record exists; else r is the last
    nxt = j + 1 == width  # the second record opens window i + 1
    i1 = i + nxt
    assert (i1[pair] < m).all()  # starts is never read past its end
    s0 = starts[i.astype(np.int64)].astype(np.int64)
    s1 = starts[np.minimum(i1, m - 1).astype(np.int64)].astype(np.int64)
    # The device-side assert: the starts read in [0, rows - width].
    assert ((s0 >= 0) & (s0 <= max_start)).all()
    assert ((s1[pair] >= 0) & (s1[pair] <= max_start)).all()
    src0 = s0 + j.astype(np.int64)
    src1 = s1 + np.where(nxt, 0, j + 1).astype(np.int64)
    assert (src0 < rows.shape[0]).all() and (src1[pair] < rows.shape[0]).all()
    r = r.astype(np.int64)
    out[r] = rows[src0]
    np.add.at(writes, r, 1)
    out[r[pair] + 1] = rows[src1[pair]]
    np.add.at(writes, r[pair] + 1, 1)
    return out.reshape(m, width, 2), writes


@functools.lru_cache(maxsize=None)
def _tables():
    """(JAX, port) slim combined CSRs in granule-pairs form over one random
    graph (12 relations, 700 edges), and its edge count."""
    rng = np.random.default_rng(0)
    n, r, e = 80, 12, 700
    src, dst, rel = (rng.integers(0, n, e), rng.integers(0, n, e),
                     rng.integers(0, r, e))
    jc = js.build_combined_csr(j_build(src, dst, rel, n, r,
                                       bucket_pad_multiple=64,
                                       use_native="never"),
                               slim=True, window_pairs=True)
    pc = ps.build_combined_csr(p_build(src, dst, rel, n, r,
                                       bucket_pad_multiple=64),
                               slim=True, window_pairs=True)
    return jc, pc, int(pc.row_start[-1])


M_KINDS = ("one", "below_block", "ragged", "thousands")


def _window_count(width, kind):
    """M: one window; fewer records than one block's share; a count whose
    records are no multiple of that share; a few thousand, even for an
    odd width so that the four hold odd and even record counts."""
    share = 2 * THREADS
    ragged = 3 * share // width + 1
    if (ragged * width) % share == 0:
        ragged += 1
    return {"one": 1, "below_block": max(1, share // width - 1),
            "ragged": ragged, "thousands": 3000 + (width % 2 == 0)}[kind]


def test_source_constants():
    assert THREADS == 256
    assert "template" not in SOURCE  # one instance, one chunk a thread
    assert len(pwf.LIBRARY.functions["window_rows_fetch_i32"]) == 7


def test_window_counts_cover_odd_and_even_record_counts():
    for width in WIDTHS:
        parities = {_window_count(width, kind) * width % 2
                    for kind in M_KINDS}
        assert parities == ({0} if width % 2 == 0 else {0, 1}), width


@pytest.mark.parametrize("kind", M_KINDS)
@pytest.mark.parametrize("width", WIDTHS)
def test_flat_mapping_writes_each_record_once(width, kind):
    _, pc, _ = _tables()
    rows = pc.packed.view(-1, 2).numpy()
    m = _window_count(width, kind)
    rng = np.random.default_rng([width, m])
    starts = rng.integers(0, rows.shape[0] - width + 1, m).astype(np.int32)
    starts[0] = rows.shape[0] - width  # the last window the table holds
    if m > 1:
        starts[1] = 0
    want = pwf.window_rows_fetch_plain(pc.packed, torch.from_numpy(starts),
                                       width)
    got, writes = emulate_b3(rows, starts, width)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))
    # On the CPU the wrapper runs the plain version.
    assert torch.equal(pwf.window_rows_fetch(
        pc.packed, torch.from_numpy(starts), width), want)


@pytest.mark.parametrize("width", WIDTHS)
def test_flat_mapping_equals_jax_pallas(width):
    jc, pc, e = _tables()
    rows = pc.packed.view(-1, 2).numpy()
    np.testing.assert_array_equal(rows, np.asarray(jc.packed).reshape(-1, 2))
    rng = np.random.default_rng(100 + width)
    # The JAX kernel reads the two granules from a start's own: starts up
    # to the edge count, as the sampler gives it.
    starts = np.concatenate([rng.integers(0, e + 1, 2045),
                             [0, 1, e - 1, e]]).astype(np.int32)
    got, writes = emulate_b3(rows, starts, width)
    assert (writes == 1).all()
    want = jwf.window_rows_fetch(jc.packed, jnp.asarray(starts), width,
                                 impl="pallas")
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))
