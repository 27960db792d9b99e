"""The yardstick's arithmetic against hand-worked values, and its frozen
copies against what they were copied from."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.yardstick import roofline, split, synthetic, trace
from portbench.yardstick.roofline import F32_FLOPS, HBM_BYTES_PER_S


def test_b1_bound_counts_each_byte_once():
    # table 11 x 4 float32 (176 B), 20 ids + 12 offsets + 11 x 4 output
    # (304 B); 160 operations, far below the byte time.
    assert roofline.b1_bound_s(11, 4, 20, 11) == pytest.approx(
        480 / HBM_BYTES_PER_S)
    assert roofline.b1_bound_s(11, 4, 20, 11, scaled=True) == pytest.approx(
        560 / HBM_BYTES_PER_S)


def test_b2_bound_counts_each_byte_once():
    # 10 rows x 8 (320 B), 12 ids (48 B), 5 x 8 output (160 B).
    assert roofline.b2_bound_s(10, 12, 8, 5) == pytest.approx(
        528 / HBM_BYTES_PER_S)
    # The restricted layer: 64 slots in groups of 8 -> 8 rows of 8, into
    # 2 relations x 3 batch nodes.
    assert roofline.restricted_b2_bound_s(64, 8, 2, 3, 8) == pytest.approx(
        (8 * 8 * 4 + 8 * 4 + 6 * 8 * 4) / HBM_BYTES_PER_S)


def test_operations_bound_where_they_dominate():
    # 1e6 edges at width 1,000: 2e9 operations outweigh the bytes.
    assert roofline.b1_bound_s(1, 1000, 10 ** 6, 1) == pytest.approx(
        2e9 / F32_FLOPS)


def test_full_layer_bound_is_both_ways_over_non_empty_buckets():
    fwd = roofline.b1_bound_s(3, 4, 512, 11)
    bwd = roofline.b1_bound_s(7, 4, 512, 11)
    assert roofline.full_layer_b1_bound_s(
        [512, 0, 512], [3, 0, 3], [7, 0, 7], 10, 4,
        scaled=False) == pytest.approx(2 * (fwd + bwd))


def test_b1_bound_of_a_small_bucket_by_hand():
    # Nodes 0-4; bucket 0 holds (0 -> 2), (1 -> 2), (0 -> 3), bucket 1
    # (4 -> 0), bucket 2 nothing. Bucket 0's forward gathers sources {0, 1}
    # (2 rows x 4 float32 = 32 B), its backward destinations {2, 3} (32 B);
    # each call also moves 3 ids, 7 offsets and a 6 x 4 output
    # ((3 + 7 + 24) x 4 = 136 B). Bucket 1: 1 row each way, 1 id: 16 +
    # (1 + 7 + 24) x 4 = 144 B a call.
    src, dst = np.array([0, 1, 0, 4]), np.array([2, 2, 3, 0])
    rel = np.array([0, 0, 0, 1])
    srcs, dsts = roofline.bucket_rows(src, dst, rel, 5, 3)
    assert (srcs, dsts) == ([2, 1, 0], [2, 1, 0])
    got = roofline.full_layer_b1_bound_s([3, 1, 0], srcs, dsts, 5, 4,
                                         scaled=False)
    assert got == pytest.approx((2 * 168 + 2 * 144) / HBM_BYTES_PER_S)


def test_update_flops_by_hand():
    # Nodes 0-4; edges (src, dst, rel). The scored triple (0, r, 4):
    # conv2 at {0, 4}: 4 in-edges, 3 (node, relation) pairs, 2 rows;
    # conv1 at {0, 4} and their in-neighbours {0, 1, 2, 3}: 5 in-edges,
    # 4 pairs, 5 rows. Widths 2 -> 3 -> 3.
    src = np.array([1, 2, 3, 0, 4])
    dst = np.array([0, 0, 0, 4, 3])
    rel = np.array([0, 0, 1, 1, 0])
    ie = roofline.InEdges(src, dst, rel, 5)
    l1 = 5 * 2 + 4 * 2 + 2 * 4 * 2 * 3 + 2 * 5 * 2 * 3 + 5 * 3
    l2 = 4 * 3 + 3 * 3 + 2 * 3 * 3 * 3 + 2 * 2 * 3 * 3 + 2 * 3
    dec = 3 * 3 * 1
    got = roofline.update_flops(ie, [np.array([0, 4])], 2, 3)
    assert got == 3 * (l1 + l2 + dec) == 801


def test_split_rule_by_hand():
    # 10 target rows (rel 0) and 3 others: ceil(0.3 * 10) = 3 rows held
    # out by RandomState(5).permutation(10); the other relation stays.
    src, dst = np.arange(13), np.arange(13) + 100
    rel = np.array([0] * 10 + [1] * 3)
    out = split.split_rows(src, dst, rel, 0, 5)
    perm = np.random.RandomState(5).permutation(10)
    rows = np.concatenate([perm[3:], [10, 11, 12]])
    assert (out["train"][0::2, 0] == src[rows]).all()
    assert (out["train"][1::2, 0] == dst[rows]).all()
    assert out["train"].shape == (2 * 10, 3)
    held = np.sort(np.concatenate([out["val"][0::2, 0],
                                   out["test"][0::2, 0]]))
    assert (held == np.sort(perm[:3])).all()


@pytest.mark.parametrize("maker,scale", [("primekg_like", 0.05),
                                         ("primekg_full_like", 0.03)])
def test_frozen_generators_equal_the_ports(maker, scale, monkeypatch):
    from primekg_rgcn_tpu_torch.data import synthetic as port

    # The frozen full-PrimeKG table holds the census's row counts; with the
    # same table the port's generator draws the same arrays.
    monkeypatch.setattr(port, "PRIMEKG_FULL_RELATIONS",
                        synthetic.PRIMEKG_FULL_RELATIONS)

    mine = synthetic.MAKERS[maker](11, scale)
    theirs = getattr(port, maker)(seed=11, scale=scale)
    for key in ("src", "dst", "rel"):
        assert np.array_equal(mine[key], theirs[key])
    assert mine["num_nodes"] == theirs["num_nodes"]
    b = synthetic.bidirect(mine["src"], mine["dst"], mine["rel"])
    assert all(np.array_equal(x, y) for x, y in
               zip(b, port.bidirect(theirs["src"], theirs["dst"],
                                    theirs["rel"])))


def test_full_scale_counts_of_the_configs():
    assert sum(synthetic.PRIMEKG_FULL_TYPE_SIZES.values()) == 129_375
    rows = {r[0]: r[3] for r in synthetic.PRIMEKG_FULL_RELATIONS}
    # The census: 4,050,249 relationships, kg.csv's 8,100,498 rows halved.
    assert len(rows) == 30 and sum(rows.values()) == 4_050_249
    assert (rows["drug_drug"], rows["anatomy_protein_present"],
            rows["protein_protein"], rows["drug_protein"]) == (
        1_336_314, 1_518_203, 321_075, 25_653)
    assert sum(synthetic.PRIMEKG_REL_ROWS.values()) == 854_278


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_counts_only_between_markers():
    m = trace.MARKER_KERNEL
    events = [
        _ev("stray", 0, 5),                          # before the markers
        _ev(m, 10, 2), _ev(m, 20, 2),                # head markers
        _ev("gather_segment_sum_kernel<f>", 30, 10),
        _ev("gather_segment_sum_fixup_kernel", 38, 4),   # overlaps: 30-42
        _ev("Memcpy HtoD", 50, 10, cat="gpu_memcpy"),
        _ev("dense_segment_sum_kernel", 70, 2),
        _ev("cudaGraphLaunch", 60, 12, cat="cuda_runtime"),
        _ev(m, 80, 2), _ev(m, 90, 2),                # tail markers
    ]
    s = trace.summarize(events)
    # Window 22 .. 80 (58 us); busy 12 + 10 + 2 = 24 us.
    assert s.window_s == pytest.approx(58e-6)
    assert s.busy_s == pytest.approx(24e-6)
    assert s.idle_share == pytest.approx(1 - 24 / 58)
    assert s.family_s["B1"] == pytest.approx(14e-6)
    assert s.family_s["B2"] == pytest.approx(2e-6)
    assert (s.head_marks, s.tail_marks) == (2, 2)
    gaps = dict(s.idle_gaps)
    assert gaps["cudaGraphLaunch"] == pytest.approx(10e-6)   # 60 .. 70
    assert gaps["host idle"] == pytest.approx(24e-6)         # 22-30, 42-50, 72-80
    # A trace that lost its head markers gives no summary.
    assert trace.summarize([e for e in events
                            if not (e["name"] == m and e["ts"] < 30)]) is None
