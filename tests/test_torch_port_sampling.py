"""The port's sampler against the JAX package's: the CSR construction bit for
bit, kernels B2 and B3's plain versions against the JAX entry points (the
Pallas kernels interpreted on the CPU), the dedup, and sampled blocks field
for field with the JAX draws handed to the port.

Exact where the arithmetic is the same (CSR arrays, window fetches, sampled
blocks); B2 at rtol 2e-4, atol 2e-5 (the two sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.data import sampling as js
from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.ops.pallas import segment_sum as jseg
from primekg_rgcn_tpu.ops.pallas import window_fetch as jwf
from primekg_rgcn_tpu_torch.data import sampling as ps
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds
from primekg_rgcn_tpu_torch.ops.cuda import window_fetch as pwf


class JaxDraws:
    """The port's ``draw`` replaying the JAX sampler's key chain:
    ``key, k = split(key); uniform(k, shape)`` per draw."""

    def __init__(self, key):
        self.key = key

    def __call__(self, shape):
        self.key, k = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.uniform(k, shape)))


def _graphs(kind, seed=0):
    """(jax graph, port graph) on the same directed edges. "hub": one
    (dst, rel) run of 2,049 edges, whose float16 degree rounds to 2,048;
    "empty": node 0 and the last node have no in-edge; "sparse": 12
    relations, few edges each."""
    rng = np.random.default_rng(seed)
    if kind == "hub":
        n, r, e = 150, 3, 900
        src = np.concatenate([rng.integers(0, n, e), rng.integers(0, n, 2049)])
        dst = np.concatenate([rng.integers(0, n, e), np.full(2049, 7)])
        rel = np.concatenate([rng.integers(0, r, e), np.full(2049, 1)])
    elif kind == "empty":
        n, r, e = 90, 3, 600
        src = rng.integers(0, n // 2, e)
        dst = rng.integers(1, n - 1, e)
        rel = rng.integers(0, r, e)
    else:
        n, r, e = 80, 12, 700
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
        rel = rng.integers(0, r, e)
    jg = j_build(src, dst, rel, n, r, bucket_pad_multiple=64,
                 use_native="never")
    pg = p_build(src, dst, rel, n, r, bucket_pad_multiple=64)
    return jg, pg


def _eq(ours, theirs):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    theirs = np.asarray(theirs)
    assert ours.dtype == theirs.dtype, (ours.dtype, theirs.dtype)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("kind", ["hub", "empty"])
def test_csr_cache_equals_jax(kind):
    jg, pg = _graphs(kind)
    jc, pc = js.build_csr_cache(jg), ps.build_csr_cache(pg)
    for name in ("row_start", "row_count", "col"):
        for ours, theirs in zip(getattr(pc, name), getattr(jc, name)):
            _eq(ours, theirs)
    assert (pc.num_nodes, pc.num_relations) == (jc.num_nodes, jc.num_relations)


@pytest.mark.parametrize("kind", ["hub", "empty", "sparse"])
@pytest.mark.parametrize("layout", ["fat", "slim", "pairs"])
def test_combined_csr_equals_jax(kind, layout):
    jg, pg = _graphs(kind)
    kw = dict(slim=layout != "fat", window_pairs=layout == "pairs")
    jc, pc = js.build_combined_csr(jg, **kw), ps.build_combined_csr(pg, **kw)
    for name in ("row_start", "col", "rel", "edge_deg", "deg_total",
                 "deg_rel_flat", "packed"):
        _eq(getattr(pc, name), getattr(jc, name))
    assert pc.avg_present_relations == jc.avg_present_relations
    assert ps.packed_is_pairs(pc.packed) == js.packed_is_pairs(jc.packed)
    if layout == "pairs":
        # The pairs form is a view of the row form's bytes.
        row = ps.build_combined_csr(pg, slim=True)
        assert torch.equal(pc.packed.view(-1, 2), row.packed)
        assert torch.equal(ps.csr_to_pairs_form(row).packed, pc.packed)


def test_hub_run_rounds_in_float16_and_unpacked_fallback():
    jg, pg = _graphs("hub")
    pc = ps.build_combined_csr(pg)
    n, r = pg.num_nodes, pg.num_relations
    # Node 7's relation-1 run: 2,049 hub edges plus the random ones, its
    # float16 degree a multiple of 2 (the spacing above 2,048).
    deg = float(pc.deg_rel_flat[7 * r + 1])
    assert deg >= 2048 and deg % 2 == 0
    # A run of 60,000 or more keeps float32, which the packed record cannot
    # hold: the slim layout falls back to separate per-edge arrays.
    big_src = np.zeros(60000, np.int64)
    big_dst = np.full(60000, 3)
    big_rel = np.zeros(60000, np.int64)
    jg2 = j_build(big_src, big_dst, big_rel, 10, 2, use_native="never")
    pg2 = p_build(big_src, big_dst, big_rel, 10, 2)
    jc2 = js.build_combined_csr(jg2, slim=True)
    pc2 = ps.build_combined_csr(pg2, slim=True)
    assert pc2.packed.shape[0] == 0 and pc2.edge_deg.dtype == torch.float32
    for name in ("row_start", "col", "rel", "edge_deg", "deg_total"):
        _eq(getattr(pc2, name), getattr(jc2, name))
    assert n > 0


@pytest.mark.parametrize("form", ["row", "pairs"])
@pytest.mark.parametrize("width", [1, 6, 24, 64])
def test_window_fetch_plain_equals_jax_pallas(form, width):
    jg, pg = _graphs("sparse")
    jc = js.build_combined_csr(jg, slim=True, window_pairs=form == "pairs")
    pc = ps.build_combined_csr(pg, slim=True, window_pairs=form == "pairs")
    e = int(pc.row_start[-1])
    rng = np.random.default_rng(width)
    starts = np.concatenate([rng.integers(0, e, 40), [0, e - 1, e]])
    starts = starts.astype(np.int32)
    want = jwf.window_rows_fetch(jc.packed, jnp.asarray(starts), width,
                                 impl="pallas")
    got = pwf.window_rows_fetch_plain(pc.packed, torch.from_numpy(starts),
                                      width)
    _eq(got, want)
    assert torch.equal(pwf.window_rows_fetch(pc.packed,
                                             torch.from_numpy(starts), width),
                       got)


def test_window_fetch_wrapper_rejects_malformed_input():
    _, pg = _graphs("sparse")
    packed = ps.build_combined_csr(pg, slim=True).packed
    starts = torch.zeros(4, dtype=torch.int32)
    before = pwf.window_rows_fetch.launches
    with pytest.raises(ValueError, match="width 65"):
        pwf.window_rows_fetch(packed, starts, 65)
    with pytest.raises(ValueError, match="width 0"):
        pwf.window_rows_fetch(packed, starts, 0)
    with pytest.raises(ValueError, match="starts must be int32"):
        pwf.window_rows_fetch(packed, starts.long(), 8)
    with pytest.raises(ValueError, match="packed must be int32"):
        pwf.window_rows_fetch(packed.view(-1)[:6].view(2, 3), starts, 8)
    rows = packed.shape[0]
    for bad in (-1, rows - 7):
        with pytest.raises(ValueError, match="window starts"):
            pwf.window_rows_fetch(packed, torch.tensor([0, bad],
                                                       dtype=torch.int32), 8)
    assert pwf.window_rows_fetch.launches == before


def _b2_case(kind, d, seed):
    rng = np.random.default_rng(seed)
    n = 700
    if kind == "random":
        ids = np.sort(rng.integers(0, n, 1500))
    elif kind == "sentinel_tail":
        ids = np.concatenate([np.sort(rng.integers(0, n, 900)),
                              np.full(600, n)])
    elif kind == "giant_run":
        ids = np.concatenate([np.sort(rng.integers(0, 40, 100)),
                              np.full(1400, 41), [n - 1]])
    elif kind == "distinct":
        ids = np.arange(0, n, 2)
    elif kind == "only_sentinels":
        ids = np.full(300, n)
    else:  # empty
        ids = np.zeros(0, np.int64)
    msg = rng.standard_normal((ids.shape[0], d)).astype(np.float32)
    if kind == "giant_run":
        # Positive rows: a 1,400-term signed sum can cancel to near zero,
        # where the two summation orders' rounding exceeds any atol.
        msg = np.abs(msg)
    return msg, ids.astype(np.int32), n


@pytest.mark.parametrize("kind", ["random", "sentinel_tail", "giant_run",
                                  "distinct", "only_sentinels", "empty"])
@pytest.mark.parametrize("d", [3, 64])
def test_dense_segment_sum_plain_matches_jax(kind, d):
    msg, ids, n = _b2_case(kind, d, seed=d)
    want = np.asarray(jseg.dense_sorted_segment_sum(
        jnp.asarray(msg), jnp.asarray(ids), n))
    got = pds.dense_sorted_segment_sum_plain(torch.from_numpy(msg),
                                             torch.from_numpy(ids), n)
    assert got.shape == (n, d) and got.dtype == torch.float32
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-5 * scale)
    before = pds.dense_sorted_segment_sum.launches
    wrapped = pds.dense_sorted_segment_sum(torch.from_numpy(msg),
                                           torch.from_numpy(ids), n)
    assert torch.equal(wrapped, got)
    assert pds.dense_sorted_segment_sum.launches == before


def test_dense_segment_sum_wrapper_rejects_malformed_input():
    msg = torch.ones(4, 8)
    ids = torch.tensor([0, 1, 1, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="non-decreasing"):
        pds.dense_sorted_segment_sum(msg, ids.flip(0), 5)
    with pytest.raises(ValueError, match="non-decreasing"):
        pds.dense_sorted_segment_sum(msg, ids - 1, 5)
    with pytest.raises(ValueError, match="msg must be float32"):
        pds.dense_sorted_segment_sum(msg.double(), ids, 5)
    with pytest.raises(ValueError, match="srt must be int32"):
        pds.dense_sorted_segment_sum(msg, ids.long(), 5)
    with pytest.raises(ValueError, match="srt must be int32"):
        pds.dense_sorted_segment_sum(msg, ids[:3], 5)
    with pytest.raises(ValueError, match="contiguous"):
        pds.dense_sorted_segment_sum(torch.ones(8, 4).T, ids, 5)


def test_libraries_are_keyed_by_source():
    for mod, stem in ((pds, "dense_segment_sum"), (pwf, "window_fetch")):
        path = mod.LIBRARY.library_path()
        assert path.name.startswith(f"lib{stem}_")
        assert mod.LIBRARY.source.exists()


@pytest.mark.parametrize("seed,n", [(0, 50), (1, 300)])
def test_sorted_unique_is_exact(seed, n):
    rng = np.random.default_rng(seed)
    raw = np.concatenate([rng.integers(0, n + 1, 200), [n, n]]).astype(np.int32)
    cap = ps._unique_cap(raw.shape[0], n)
    want = js._sorted_unique(jnp.asarray(raw), cap, n)
    got = ps._sorted_unique(torch.from_numpy(raw), cap, n)
    for ours, theirs in zip(got, want):
        _eq(ours, theirs)
    # Seed dedup: jnp.unique(size=, fill_value=, return_inverse=True).
    uniq, inv = jnp.unique(jnp.asarray(raw), return_inverse=True, size=cap,
                           fill_value=n)
    pu, pi = ps._unique_seeds(torch.from_numpy(raw), n)
    _eq(pu, uniq)
    _eq(pi, np.asarray(inv).astype(np.int32).reshape(-1))


def _blocks_equal(pb, jb):
    if jb.frontier is None:
        assert pb.frontier is None
    else:
        _eq(pb.frontier, jb.frontier)
    _eq(pb.seed_gather, jb.seed_gather)
    assert len(pb.blocks) == len(jb.blocks)
    for ours, theirs in zip(pb.blocks, jb.blocks):
        assert type(ours).__name__ == type(theirs).__name__
        for f in theirs._fields:
            a, b = getattr(ours, f), getattr(theirs, f)
            if isinstance(a, torch.Tensor):
                _eq(a, b)
            else:
                assert a == b, f


@pytest.mark.parametrize("mode", ["uniform", "truncate"])
def test_sample_batch_per_relation_equals_jax(mode):
    jg, pg = _graphs("empty")
    seeds = np.random.default_rng(3).integers(0, pg.num_nodes, 24)
    key = jax.random.PRNGKey(5)
    jb = js.sample_batch(key, js.build_csr_cache(jg),
                         jnp.asarray(seeds, jnp.int32), (4, 3), mode=mode)
    pb = ps.sample_batch(JaxDraws(key), ps.build_csr_cache(pg),
                         torch.from_numpy(seeds), (4, 3), mode=mode)
    _blocks_equal(pb, jb)


@pytest.mark.parametrize("mode", ["uniform", "truncate", "block", "block4"])
@pytest.mark.parametrize("regime", ["ident", "dedup"])
@pytest.mark.parametrize("layout", ["fat", "slim"])
def test_sample_batch_combined_equals_jax(mode, regime, layout, monkeypatch):
    if regime == "dedup":
        monkeypatch.setenv("PRIMEKG_IDENT_FRACTION", "1000")
    jg, pg = _graphs("sparse")
    slim = layout == "slim"
    jc = js.build_combined_csr(jg, slim=slim)
    pc = ps.build_combined_csr(pg, slim=slim)
    seeds = np.random.default_rng(4).integers(0, pg.num_nodes, 30)
    key = jax.random.PRNGKey(9)
    jb = js.sample_batch_combined(key, jc, jnp.asarray(seeds, jnp.int32),
                                  (8, 4), mode=mode, allow_ident=True)
    pb = ps.sample_batch_combined(JaxDraws(key), pc, torch.from_numpy(seeds),
                                  (8, 4), mode=mode, allow_ident=True)
    assert pb.blocks[0].ident == (regime == "ident")
    _blocks_equal(pb, jb)


@pytest.mark.parametrize("mode", ["block", "block2"])
def test_block_over_slim_pairs_equals_block_over_fat(mode):
    _, pg = _graphs("hub")
    fat = ps.build_combined_csr(pg)
    pairs = ps.build_combined_csr(pg, slim=True, window_pairs=True)
    seeds = torch.arange(0, 40, dtype=torch.int32)
    a = ps.sample_batch_combined(JaxDraws(jax.random.PRNGKey(1)), fat, seeds,
                                 (8, 6), mode=mode, allow_ident=True)
    b = ps.sample_batch_combined(JaxDraws(jax.random.PRNGKey(1)), pairs,
                                 seeds, (8, 6), mode=mode, allow_ident=True)
    for x, y in zip(a.blocks, b.blocks):
        for f in x._fields:
            u, v = getattr(x, f), getattr(y, f)
            assert torch.equal(u, v) if isinstance(u, torch.Tensor) else u == v
    with pytest.raises(ValueError, match="granule-pairs"):
        ps.sample_batch_combined(JaxDraws(jax.random.PRNGKey(1)), pairs,
                                 seeds, (8, 6), mode="uniform")


def test_parse_sample_mode_and_unported_reductions(monkeypatch):
    assert ps.parse_sample_mode("block") == ("block", 1)
    assert ps.parse_sample_mode("block4") == ("block", 4)
    assert ps.parse_sample_mode("uniform") == ("uniform", 1)
    with pytest.raises(ValueError):
        ps.parse_sample_mode("blockx")
    _, pg = _graphs("sparse")
    pc = ps.build_combined_csr(pg)
    with pytest.raises(ValueError, match="must divide"):
        ps.sample_batch_combined(JaxDraws(jax.random.PRNGKey(0)), pc,
                                 torch.arange(4), (6, 4), mode="block4")
    # The rowwise reduction agrees with the einsum one, and refuses a block
    # sampled for the einsum (its tags unsorted), as the JAX package's
    # test_rowwise_impl_agrees_and_guards holds.
    from primekg_rgcn_tpu_torch.config import ModelConfig
    from primekg_rgcn_tpu_torch.models import rgcn as pmodel

    cfg = ModelConfig(num_nodes=pg.num_nodes, num_relations=pg.num_relations,
                      embedding_dim=8, hidden_dim=8, dropout=0.0)
    params = pmodel.init_params(torch.Generator().manual_seed(0), cfg)
    seeds = torch.arange(20, dtype=torch.int32)
    b_e = ps.sample_batch_combined(JaxDraws(jax.random.PRNGKey(11)), pc,
                                   seeds, (6, 5))
    out_e = pmodel.encoder_apply_sampled(params, b_e, cfg)
    monkeypatch.setenv("PRIMEKG_COMBINED_AGG", "rowwise")
    b_r = ps.sample_batch_combined(JaxDraws(jax.random.PRNGKey(11)), pc,
                                   seeds, (6, 5))
    assert b_r.blocks[0].tags_sorted and not b_e.blocks[0].tags_sorted
    out_r = pmodel.encoder_apply_sampled(params, b_r, cfg)
    np.testing.assert_allclose(out_r.numpy(), out_e.numpy(), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="PRIMEKG_COMBINED_AGG"):
        pmodel.encoder_apply_sampled(params, b_e, cfg)
