"""Kernel B2's row split (``csrc/dense_segment_sum.cu``) and its two newer
callers, against the JAX package.

- The split itself, on the CPU: ``emulate_b2`` below walks the kernel's
  algorithm step for step (the zeros, the search for L_real, pieces of
  equal length, direct writes, carries, the fix-up) on small streams shaped
  like the card's cases; the split must write each segment that a run
  carries exactly once, and the result must be the plain version's.
- ``piece_plan``: the pieces cover ``[0, L)`` exactly once for L from 0 to
  10^6 and 1, 132 and 264 SMs.
- B2's plain version against ``primekg_rgcn_tpu.ops.pallas.segment_sum.
  dense_sorted_segment_sum`` (the Pallas kernel interpreted on the CPU), at
  float32 and bf16, on those stream shapes.
- ``SortedSegmentSum`` (the restricted final layer's forward segment-sum)
  against ``jax.ops.segment_sum`` and its VJP.
- ``data/sampling._sorted_accumulate`` against the JAX one on both sides of
  its 2^18-segment switch, and bit for bit against ``index_add_``, the sum
  it replaced on the CPU.

Inputs come from ``np.random.default_rng``. Tolerances: rtol 2e-4, atol
2e-5 times the largest magnitude where the two sides sum float32 in
different orders (as ``test_torch_port_sampling.py``); bf16 rows are
widened exactly on both sides, so float32 sums keep that tolerance; a bf16
result (``_sorted_accumulate`` returns its input's dtype) is held at rtol
and atol 2e-2 times the largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.data import sampling as js
from primekg_rgcn_tpu.ops.pallas import segment_sum as jseg
from primekg_rgcn_tpu_torch.data import sampling as ps
from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds

BF16 = torch.bfloat16


def _close(got, want, rtol=2e-4, atol=2e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


# -- the kernel's algorithm, in numpy -----------------------------------------


def emulate_b2(msg, ids, n, num_pieces, min_rows, vec=1):
    """``csrc/dense_segment_sum.cu`` step for step: the zero launch, then
    the row split one piece (warp) after another, then the fix-up. Returns
    the output and how often the split writes each output vector of ``vec``
    floats (each segment that a run carries once, the others never)."""
    rows, d = msg.shape
    dv = d // vec
    out = np.zeros((n * dv, vec))
    writes = np.zeros(n * dv, np.int64)
    msg_v = msg.astype(np.float64).reshape(rows, dv, vec)
    l_real = int(np.searchsorted(ids, n, side="left"))  # first id >= n
    per = max(min_rows, -(-l_real // num_pieces))
    carry = np.full((num_pieces, dv, vec), np.nan)
    for p in range(num_pieces):
        r0, r1 = min(p * per, l_real), min(p * per + per, l_real)
        acc = np.zeros((dv, vec))
        for j in range(r0, r1):
            acc = acc + msg_v[j]
            cur = int(ids[j])
            nxt = int(ids[j + 1]) if j + 1 < rows else n
            if cur != nxt:  # a run ends: its sum
                out[cur * dv:(cur + 1) * dv] = acc
                writes[cur * dv:(cur + 1) * dv] += 1
                acc = np.zeros((dv, vec))
        if r0 < r1 < l_real and ids[r1 - 1] == ids[r1]:
            carry[p] = acc
    # The fix-up: the first piece that carries a run adds all its carries.
    for p in range(num_pieces):
        r0, r1 = min(p * per, l_real), min(p * per + per, l_real)
        if r0 >= r1 or r1 >= l_real:
            continue
        rid = int(ids[r1 - 1])
        if ids[r1] != rid or (r0 > 0 and ids[r0 - 1] == rid):
            continue
        # The run's end: in the next piece when that piece's last id
        # differs, else found by a search.
        n1 = min(r1 + per, l_real)
        e = (n1 if n1 == l_real or ids[n1 - 1] != rid else
             n1 + int(np.searchsorted(ids[n1:l_real], rid + 1, side="left")))
        count = (e - 1) // per - p
        assert count >= 1
        part = carry[p:p + count]
        assert not np.isnan(part).any(), "a carry the kernel never wrote"
        out[rid * dv:(rid + 1) * dv] += part.sum(0)
    return out.reshape(n, d), writes


def _stream(kind, rng, n=600):
    """(ids, n) of one stream shape of the card's B2 cases, small."""
    if kind == "long_run":  # one run across many pieces
        ids = np.concatenate([np.sort(rng.integers(0, 50, 300)),
                              np.full(2500, 50),
                              np.sort(rng.integers(51, n, 400))])
    elif kind == "leading_gap":
        ids = np.sort(rng.integers(450, 520, 1500))
    elif kind == "one_real_row":
        ids = np.concatenate([[7], np.full(999, n)])
    elif kind == "only_sentinels":
        ids = np.full(500, n + 3)
    elif kind == "dedup_fill":  # distinct frontier ids, then the fill run
        ids = np.concatenate([np.repeat(np.arange(n - 1),
                                        rng.integers(1, 4, n - 1)),
                              np.full(1800, n - 1)])
    elif kind == "restricted":  # (relation, node) runs, padding at the end
        b, parts = n // 4, []
        for r in range(4):
            parts.append(np.sort(rng.choice(b, 60)) + r * b)
            parts.append(np.full(300, (r + 1) * b - 1))
        ids = np.concatenate(parts)
    elif kind == "sentinel_tail":  # the identity backward's shape
        ids = np.concatenate([np.sort(rng.integers(0, n, 2000)),
                              np.full(800, n)])
    else:  # "distinct"
        ids = np.arange(0, 2 * n, 2) // 2
    return ids.astype(np.int32), n


KINDS = ["long_run", "leading_gap", "one_real_row", "only_sentinels",
         "dedup_fill", "restricted", "sentinel_tail", "distinct"]


@pytest.mark.parametrize("pieces,min_rows,vec", [
    (1, 64, 1), (7, 4, 2), (16, 64, 4), (50, 1, 1)])
@pytest.mark.parametrize("kind", KINDS)
def test_split_writes_each_carried_segment_once_and_sums_right(
        kind, pieces, min_rows, vec):
    rng = np.random.default_rng(KINDS.index(kind))
    ids, n = _stream(kind, rng)
    msg = rng.standard_normal((ids.shape[0], 8)).astype(np.float32)
    got, writes = emulate_b2(msg, ids, n, pieces, min_rows, vec)
    carried = np.zeros(n, bool)
    carried[ids[ids < n]] = True
    assert (writes == np.repeat(carried, 8 // vec)).all()
    want = pds.dense_sorted_segment_sum_plain(torch.from_numpy(msg),
                                              torch.from_numpy(ids), n)
    _close(got, want.numpy())


@pytest.mark.parametrize("per", [2, 5, 64])
def test_split_with_runs_cut_at_every_piece_boundary(per):
    # ids = row // (per - 1): every piece ends inside a run, and the run
    # ends a row later, in the next piece.
    rows = 40 * per
    ids = (np.arange(rows) // max(per - 1, 1)).astype(np.int32)
    n = int(ids[-1]) + 5
    pieces = rows // per
    msg = np.random.default_rng(per).standard_normal(
        (rows, 4)).astype(np.float32)
    got, writes = emulate_b2(msg, ids, n, pieces, per)
    assert (writes == np.repeat(np.isin(np.arange(n), ids), 4)).all()
    want = pds.dense_sorted_segment_sum_plain(torch.from_numpy(msg),
                                              torch.from_numpy(ids), n)
    _close(got, want.numpy())


# -- the host-side plan --------------------------------------------------------


@pytest.mark.parametrize("sms", [1, 132, 264])
def test_piece_plan_covers_every_row_once(sms):
    rng = np.random.default_rng(sms)
    lengths = [0, 1, 63, 64, 65, 4096, 79331, 135168, 774400, 10 ** 6,
               *rng.integers(1, 10 ** 6, 40).tolist()]
    for rows in lengths:
        min_rows, pieces = pds.piece_plan(rows, sms)
        assert pieces >= 1 and min_rows >= 1
        assert pieces <= max(1, sms * pds.WAVE_WARPS_PER_SM)
        # The device's geometry for the worst case, no sentinel: L_real = L,
        # and for a sentinel tail that leaves a tenth of the rows real.
        for real in {rows, rows // 10}:
            per = max(min_rows, -(-real // pieces))
            bounds = [(min(p * per, real), min(p * per + per, real))
                      for p in range(pieces)]
            covered = np.zeros(real, np.int64)
            for r0, r1 in bounds:
                covered[r0:r1] += 1
            assert (covered == 1).all()
            assert bounds[-1][1] == real


def test_piece_plan_at_the_main_path():
    # The identity backward of the sampled step: 774,400 rows on 132 SMs.
    assert pds.piece_plan(774400, 132) == (64, 132 * pds.WAVE_WARPS_PER_SM)
    assert pds.piece_plan(100, 132) == (64, 2)


def test_scratch_and_widths():
    carry, meta = pds.scratch(5, 64, "cpu")
    assert carry.shape == (5, 64) and carry.dtype == torch.float32
    assert meta.shape == (7,) and meta.dtype == torch.int32
    assert pds.b2_width(64, torch.zeros(2, 64)) == (4, 16)
    assert pds.b2_width(64, torch.zeros(2, 64, dtype=BF16)) == (8, 8)
    assert pds.b2_width(128, torch.zeros(2, 128, dtype=BF16)) == (8, 16)
    assert pds.b2_width(3, torch.zeros(2, 3)) == (1, 4)


def test_bf16_library_is_the_same_source_with_its_define():
    f32, b16 = pds.LIBRARY, pds.LIBRARY_BF16
    assert f32.source == b16.source
    assert set(f32.functions) == {"dense_sorted_segment_sum_f32"}
    assert set(b16.functions) == {"dense_sorted_segment_sum_bf16"}
    assert "-DB2_ROWS_BF16" in b16.flags and "-DB2_ROWS_BF16" not in f32.flags
    assert f32.library_path() != b16.library_path()


# -- the plain version against the JAX kernel ----------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["long_run", "leading_gap", "one_real_row",
                                  "dedup_fill", "restricted", "cut_runs"])
def test_plain_matches_jax(kind, dtype):
    rng = np.random.default_rng(len(kind))
    if kind == "cut_runs":
        ids = (np.arange(2048) // 63).astype(np.int32)
        n = int(ids[-1]) + 1
    else:
        ids, n = _stream(kind, rng)
    msg = rng.standard_normal((ids.shape[0], 16)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    msg_j = jnp.asarray(msg).astype(jdt)
    want = np.asarray(jseg.dense_sorted_segment_sum(msg_j, jnp.asarray(ids),
                                                    n))
    m = torch.from_numpy(np.array(msg_j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = pds.dense_sorted_segment_sum(m, torch.from_numpy(ids), n)
    assert got.dtype == torch.float32 and got.shape == (n, 16)
    _close(got.numpy(), want)


# -- SortedSegmentSum ----------------------------------------------------------


@pytest.mark.parametrize("dtype,ids_dtype", [
    (torch.float32, torch.int64), (torch.float32, torch.int32),
    (BF16, torch.int64)])
def test_sorted_segment_sum_forward_and_grad_match_jax(dtype, ids_dtype):
    rng = np.random.default_rng(5)
    ids, n = _stream("restricted", rng, n=200)
    msg = rng.standard_normal((ids.shape[0], 8)).astype(np.float32)
    cot = rng.standard_normal((n, 8)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    msg_j = jnp.asarray(msg).astype(jdt)

    def f(x):
        return jax.ops.segment_sum(x.astype(jnp.float32), jnp.asarray(ids),
                                   num_segments=n, indices_are_sorted=True)

    want, vjp = jax.vjp(f, msg_j)
    (want_grad,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(np.array(msg_j.astype(jnp.float32))).to(dtype)
    x.requires_grad_(True)
    out = pds.SortedSegmentSum.apply(
        x, torch.from_numpy(ids).to(ids_dtype), n)
    assert out.dtype == torch.float32
    _close(out.detach().numpy(), np.asarray(want))
    out.backward(torch.from_numpy(cot))
    assert x.grad.dtype == dtype
    _close(x.grad.float().numpy(), np.asarray(want_grad.astype(jnp.float32)))


def test_sorted_segment_sum_refuses_what_int32_cannot_hold():
    with pytest.raises(ValueError, match="int32"):
        pds.SortedSegmentSum.apply(torch.ones(2, 4),
                                   torch.zeros(2, dtype=torch.int64), 2 ** 31)
    with pytest.raises(ValueError, match="int32 or int64"):
        pds.SortedSegmentSum.apply(torch.ones(2, 4),
                                   torch.zeros(2, dtype=torch.int16), 4)


# -- _sorted_accumulate --------------------------------------------------------


@pytest.mark.parametrize("segments,dtype", [
    (4096, "float32"), (1 << 18, "float32"), (1 << 18, "bfloat16"),
    (4096, "bfloat16")])
def test_sorted_accumulate_matches_jax_on_both_sides_of_the_switch(
        segments, dtype):
    # The JAX package sums targets of 2^18 rows or more with its dense
    # kernel, in float32, and the rest with XLA's segment_sum, bf16 rows in
    # bf16; the port sums in float32 at every size, so below 2^18 its bf16
    # result is held against the JAX sum of the same rows widened to
    # float32, rounded to bf16. D = 4 keeps the larger case a few MB.
    rng = np.random.default_rng(segments)
    rows = segments + 20000
    ids = np.sort(rng.integers(0, segments, rows)).astype(np.int32)
    ids[-15000:] = segments - 1  # a fill run
    gp = rng.standard_normal((rows, 4)).astype(np.float32)
    bf16 = dtype == "bfloat16"
    gp_j = jnp.asarray(gp).astype(jnp.bfloat16 if bf16 else jnp.float32)
    sum_in = gp_j.astype(jnp.float32) if segments < (1 << 18) else gp_j
    want = js._sorted_accumulate(sum_in, jnp.asarray(ids), segments)
    g = torch.from_numpy(np.array(gp_j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = ps._sorted_accumulate(g, torch.from_numpy(ids), segments)
    assert got.dtype == g.dtype and got.shape == (segments, 4)
    # bf16: both sides round a float32 sum to bf16 at the end.
    tol = dict(rtol=2e-2, atol=2e-2) if bf16 else {}
    _close(got.float().numpy(),
           np.asarray(want.astype(jnp.bfloat16 if bf16 else jnp.float32)
                      .astype(jnp.float32)), **tol)


def test_sorted_accumulate_on_the_cpu_is_index_add():
    rng = np.random.default_rng(9)
    ids = torch.from_numpy(np.sort(rng.integers(0, 300, 5000)).astype(
        np.int32))
    gp = torch.from_numpy(rng.standard_normal((5000, 16)).astype(np.float32))
    want = torch.zeros(300, 16).index_add_(0, ids.long(), gp)
    before = pds.dense_sorted_segment_sum.launches
    assert torch.equal(ps._sorted_accumulate(gp, ids, 300), want)
    assert pds.dense_sorted_segment_sum.launches == before
