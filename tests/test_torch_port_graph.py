"""The port's host data against the JAX package: synthetic graphs byte for
byte, and the relation-bucketed graph array for array."""

import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.data import artifacts as jart
from primekg_rgcn_tpu.data import graph as jgraph
from primekg_rgcn_tpu.data import synthetic as jsyn
from primekg_rgcn_tpu_torch.data import artifacts as part
from primekg_rgcn_tpu_torch.data import graph as pgraph
from primekg_rgcn_tpu_torch.data import synthetic as psyn

ARRAYS = ("src", "dst", "t_src", "t_dst", "inv_in_deg", "edge_scale",
          "t_edge_scale")


def _edges(seed, n=60, r=3, e=700):
    rng = np.random.default_rng(seed)
    # A few out-of-range ids exercise the filtering.
    src = rng.integers(-2, n + 2, e)
    dst = rng.integers(0, n, e)
    rel = rng.integers(0, r, e)
    return src, dst, rel, n, r


def _assert_same_graph(jg, pg):
    for name in ARRAYS:
        a = np.asarray(getattr(jg, name))
        b = getattr(pg, name).numpy()
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    assert jg.rel_offsets == pg.rel_offsets
    assert (jg.num_nodes, jg.num_relations, jg.num_edges) == (
        pg.num_nodes, pg.num_relations, pg.num_edges)
    assert jg.norm_mode == pg.norm_mode


def _assert_rowptr_matches_dst(pg):
    n = pg.num_nodes
    assert pg.rowptr.dtype == torch.int32
    assert tuple(pg.rowptr.shape) == (pg.num_relations, n + 2)
    for r in range(pg.num_relations):
        s, e = pg.bucket_slice(r)
        dst = pg.dst[s:e].numpy()
        rp = pg.rowptr[r].numpy()
        assert rp[0] == 0 and rp[-1] == e - s
        counts = np.bincount(dst, minlength=n + 1)
        np.testing.assert_array_equal(np.diff(rp), counts)


@pytest.mark.parametrize("pad", [32, 512])
@pytest.mark.parametrize("norm", ["dense", "edge"])
def test_build_rel_graph_matches_jax(pad, norm):
    src, dst, rel, n, r = _edges(pad)
    jg = jgraph.build_rel_graph(src, dst, rel, n, r, bucket_pad_multiple=pad,
                                norm=norm, use_native="never")
    pg = pgraph.build_rel_graph(src, dst, rel, n, r, bucket_pad_multiple=pad,
                                norm=norm)
    _assert_same_graph(jg, pg)
    _assert_rowptr_matches_dst(pg)
    for a, b in zip(jgraph.edge_arrays_from_graph(jg),
                    pgraph.edge_arrays_from_graph(pg)):
        np.testing.assert_array_equal(a, b)


def test_build_rel_graph_empty_bucket():
    src, dst, rel, n, r = _edges(3)
    keep = rel != 1
    src, dst, rel = src[keep], dst[keep], rel[keep]
    jg = jgraph.build_rel_graph(src, dst, rel, n, r, bucket_pad_multiple=32,
                                use_native="never")
    pg = pgraph.build_rel_graph(src, dst, rel, n, r, bucket_pad_multiple=32)
    _assert_same_graph(jg, pg)
    _assert_rowptr_matches_dst(pg)
    # The empty bucket keeps one multiple of padding, all into the sentinel.
    assert pg.bucket_sizes()[1] == 32
    assert pg.rowptr[1, n].item() == 0 and pg.rowptr[1, n + 1].item() == 32


def test_graph_to_moves_every_array():
    src, dst, rel, n, r = _edges(4)
    pg = pgraph.build_rel_graph(src, dst, rel, n, r, bucket_pad_multiple=32)
    moved = pg.to("cpu")
    for name in ARRAYS + ("rowptr",):
        assert torch.equal(getattr(moved, name), getattr(pg, name))
    assert moved.rel_offsets == pg.rel_offsets


@pytest.mark.parametrize("fmt", ["pt", "npz"])
def test_artifacts_read_what_the_jax_package_writes(tmp_path, fmt):
    src, dst, rel, n, r = _edges(6)
    split = {"edge_index": np.stack([src, dst]), "edge_type": rel,
             "num_nodes": n, "num_relations": r}
    raw = jsyn.primekg_like(0, scale=0.02)
    save = jart.save_split_pt if fmt == "pt" else jart.save_split_npz
    save(tmp_path / f"full_graph.{fmt}", split)
    jart.save_mappings(tmp_path / "mappings.json", jsyn.synthetic_mappings(raw))

    jds = jart.load_dataset(tmp_path, require_train=False)
    pds = part.load_dataset(tmp_path, require_train=False)
    assert pds["train"] is None and pds["mappings"] == jds["mappings"]
    np.testing.assert_array_equal(part.split_to_edges(pds["full"]),
                                  jart.split_to_edges(jds["full"]))
    _assert_same_graph(
        jart.split_to_rel_graph(jds["full"], bucket_pad_multiple=32,
                                use_native="never"),
        part.split_to_rel_graph(pds["full"], bucket_pad_multiple=32))
    with pytest.raises(FileNotFoundError):
        part.load_dataset(tmp_path)

    # The port writes what the JAX package reads.
    out = tmp_path / "port"
    out.mkdir()
    psave = part.save_split_pt if fmt == "pt" else part.save_split_npz
    psave(out / f"train_data.{fmt}", pds["full"])
    again = jart.load_dataset(out)["train"]
    for k in ("edge_index", "edge_type"):
        np.testing.assert_array_equal(again[k], jds["full"][k])
    assert (again["num_nodes"], again["num_relations"]) == (n, r)


@pytest.mark.parametrize("seed", [0, 1])
def test_primekg_like_is_byte_identical(seed):
    a = jsyn.primekg_like(seed, scale=0.02)
    b = psyn.primekg_like(seed, scale=0.02)
    for k in ("src", "dst", "rel"):
        assert a[k].dtype == b[k].dtype
        assert a[k].tobytes() == b[k].tobytes(), k
    assert a["num_nodes"] == b["num_nodes"]
    assert a["type_ranges"] == b["type_ranges"]
    for x, y in zip(jsyn.bidirect(a["src"], a["dst"], a["rel"]),
                    psyn.bidirect(b["src"], b["dst"], b["rel"])):
        assert x.tobytes() == y.tobytes()
    assert jsyn.synthetic_mappings(a) == psyn.synthetic_mappings(b)
