"""The bf16-input variants of kernels B1, B2 and B4 on the CPU, where the
wrappers run their plain versions, against the JAX package's entries at
bf16: ``sorted_segment_sum_pallas(..., mxu_dtype=bfloat16)`` and
``dense_sorted_segment_sum`` in interpret mode, ``make_gather_segment_sum``'s
VJP on the Pallas path, and the halo exchange as ``lax.all_to_all`` and the
Pallas kernel on the CPU mesh.

Tolerances: both sides sum the same bf16-exact values in float32, in other
orders, so sums hold at rtol 1e-5 and atol 1e-5 times the largest
magnitude. A bf16 gradient holds at one bf16 rounding of its float32 sum
(rtol 2**-7; edge mode rounds each scaled cotangent twice in the port,
once in JAX). An exchange moves bits: equal.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from primekg_rgcn_tpu.ops.pallas.halo import pallas_halo_exchange
from primekg_rgcn_tpu.ops.pallas.segment_sum import (dense_sorted_segment_sum,
                                                     sorted_segment_sum_pallas)
from primekg_rgcn_tpu.ops.rgcn_segment import make_gather_segment_sum
from primekg_rgcn_tpu.parallel.mesh import make_mesh as j_mesh
from primekg_rgcn_tpu_torch.ops.cuda import halo
from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds
from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as pss

BF16 = torch.bfloat16


def assert_sum_close(ours, expected):
    ours, expected = np.asarray(ours, np.float32), np.asarray(expected,
                                                              np.float32)
    scale = max(float(np.abs(expected).max()), 1e-30)
    np.testing.assert_allclose(ours, expected, rtol=1e-5, atol=1e-5 * scale)


def bf16_pair(a):
    """A float32 numpy array rounded to bf16, as a torch bf16 tensor and a
    jnp bf16 array holding the same values."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _bucket(seed, n=150, e=1024):
    """One bucket's dst-sorted edges (E a multiple of the TPU kernel's 512-
    edge chunk), its transpose and their CSRs over n + 1 rows."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n // 2, e)
    dst = np.where(rng.random(e) < 0.3, 7, rng.integers(0, n, e))
    order = np.argsort(dst, kind="stable")
    src, dst = src[order].astype(np.int32), dst[order].astype(np.int32)
    t_order = np.argsort(src, kind="stable")
    rows = np.arange(n + 2)
    scale = rng.random(e).astype(np.float32)
    return dict(n=n, src=src, dst=dst, t_src=src[t_order],
                t_dst=dst[t_order], scale=scale, t_scale=scale[t_order],
                rowptr=np.searchsorted(dst, rows).astype(np.int32),
                t_rowptr=np.searchsorted(src[t_order], rows).astype(np.int32))


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_b1_plain_on_bf16_matches_the_bf16_tpu_kernel(scaled, d):
    b = _bucket(d + scaled)
    x_t, x_j = bf16_pair(np.random.default_rng(d).standard_normal(
        (b["n"] + 1, d)))
    msg = jnp.take(x_j, jnp.asarray(b["src"]), axis=0)
    if scaled:
        msg = msg * jnp.asarray(b["scale"])[:, None]
    expected = sorted_segment_sum_pallas(
        msg, jnp.asarray(b["dst"]), b["dst"], b["n"] + 1,
        mxu_dtype=jnp.bfloat16, interpret=True)
    t = torch.from_numpy
    scale = t(b["scale"]) if scaled else None
    for fn in (pss.gather_segment_sum_plain, pss.gather_segment_sum):
        got = fn(x_t, t(b["src"]), t(b["rowptr"]), scale)
        assert got.dtype == torch.float32
        assert_sum_close(got.numpy(), expected)


@pytest.mark.parametrize("scaled", [False, True])
def test_b1_bf16_gradient_matches_the_pallas_vjp(scaled):
    b = _bucket(5 + scaled)
    n, d = b["n"], 64
    rng = np.random.default_rng(scaled)
    x_t, x_j = bf16_pair(rng.standard_normal((n + 1, d)))
    g = rng.standard_normal((n + 1, d)).astype(np.float32)
    f = make_gather_segment_sum(
        b["src"], b["dst"], b["t_src"], b["t_dst"], n + 1, impl="pallas",
        mxu_dtype=jnp.bfloat16,
        scale=jnp.asarray(b["scale"]) if scaled else None,
        t_scale=jnp.asarray(b["t_scale"]) if scaled else None)
    out_j, vjp = jax.vjp(f, x_j)
    (gx_j,) = vjp(jnp.asarray(g))
    assert out_j.dtype == jnp.float32 and gx_j.dtype == jnp.bfloat16

    t = torch.from_numpy
    xt = x_t.clone().requires_grad_(True)
    out = pss.GatherSegmentSum.apply(
        xt, (t(b["src"]), t(b["rowptr"]), t(b["scale"]) if scaled else None),
        (t(b["t_dst"]), t(b["t_rowptr"]),
         t(b["t_scale"]) if scaled else None))
    out.backward(t(g))
    assert out.dtype == torch.float32 and xt.grad.dtype == BF16
    assert_sum_close(out.detach().numpy(), out_j)
    want = np.asarray(gx_j, np.float32)
    np.testing.assert_allclose(xt.grad.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * float(np.abs(want).max()))


def test_b1_plain_rounds_each_scaled_product_to_bf16():
    """Edge mode: bf16 row x float32 scale, rounded to bf16, then summed in
    float32 (one product whose float32 value is not a bf16)."""
    x = torch.tensor([[1.0 + 2 ** -7]], dtype=BF16)
    src = torch.zeros(2, dtype=torch.int32)
    rowptr = torch.tensor([0, 2], dtype=torch.int32)
    scale = torch.tensor([1.0 + 2 ** -8, 1.0])
    got = pss.gather_segment_sum_plain(x, src, rowptr, scale)
    product = torch.tensor((1.0 + 2 ** -7) * (1.0 + 2 ** -8)).to(BF16).float()
    assert float(got) == float(product) + (1.0 + 2 ** -7)
    assert float(got) != (1.0 + 2 ** -7) * (2.0 + 2 ** -8)


@pytest.mark.parametrize("d", [64, 24])
def test_b2_plain_on_bf16_matches_the_pallas_kernel(d):
    rng = np.random.default_rng(d)
    n, ln = 300, 1500
    ids = np.sort(np.concatenate([rng.integers(0, n, ln - 400),
                                  np.full(400, n)])).astype(np.int32)
    msg_t, msg_j = bf16_pair(rng.standard_normal((ln, d)))
    expected = dense_sorted_segment_sum(msg_j, jnp.asarray(ids), n,
                                        interpret=True)
    assert expected.dtype == jnp.float32
    for fn in (pds.dense_sorted_segment_sum_plain,
               pds.dense_sorted_segment_sum):
        got = fn(msg_t, torch.from_numpy(ids), n)
        assert got.dtype == torch.float32
        assert_sum_close(got.numpy(), expected)


def _jax_exchange(send, impl):
    n = send.shape[0]

    @jax.jit
    @partial(jax.shard_map, mesh=j_mesh(n), in_specs=P("data"),
             out_specs=P("data"), check_vma=False)
    def run(s):
        if impl == "pallas":
            return pallas_halo_exchange(s[0], "data")[None]
        return jax.lax.all_to_all(s[0], "data", split_axis=0, concat_axis=0,
                                  tiled=True)[None]

    return np.asarray(run(send).astype(jnp.float32))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_b4_plain_exchanges_bf16_payloads_bit_for_bit(impl):
    n, p, d = 4, 8, 64
    send_t, send_j = bf16_pair(np.random.default_rng(1).standard_normal(
        (n, n, p, d)))
    expected = _jax_exchange(send_j, impl)
    sends = list(send_t.unbind(0))
    for fn in (halo.halo_exchange_plain, halo.halo_exchange):
        got = fn(sends)
        assert all(r.dtype == BF16 for r in got)
        np.testing.assert_array_equal(
            np.stack([r.float().numpy() for r in got]), expected)
    # The backward is the same exchange of the bf16 gradients.
    leaves = [s.clone().requires_grad_(True) for s in sends]
    recvs = halo.HaloExchange.apply(*leaves)
    sum(((i + 1) * r.float()).sum() for i, r in enumerate(recvs)).backward()
    for dsh, leaf in enumerate(leaves):
        assert leaf.grad.dtype == BF16
        for o in range(n):
            assert bool((leaf.grad[o] == o + 1).all())


def test_wrappers_take_float32_and_bf16_and_refuse_other_dtypes():
    src = torch.zeros(2, dtype=torch.int32)
    rowptr = torch.tensor([0, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pss.gather_segment_sum(torch.ones(3, 4, dtype=torch.float16), src,
                               rowptr)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pds.dense_sorted_segment_sum(torch.ones(2, 4, dtype=torch.float64),
                                     src, 3)
    with pytest.raises(ValueError, match="differ in dtype"):
        halo.halo_exchange([torch.zeros(2, 1, 4),
                            torch.zeros(2, 1, 4, dtype=BF16)])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        halo.halo_exchange([torch.zeros(1, 1, 4, dtype=torch.float16)])


def test_bf16_load_widths_count_two_byte_elements():
    # B1: a bf16 table takes the float32 table's lanes, 4 elements (8
    # bytes) a lane where D % 4 == 0 and the view is 8-byte aligned.
    t = torch.zeros(16 * 136, dtype=BF16)
    assert pss.b1_width(64, t[:64 * 16].view(16, 64)) == (4, 16)
    assert pss.b1_width(128, t[:128 * 16].view(16, 128)) == (4, 32)
    assert pss.b1_width(64, torch.zeros(4, 64)) == (4, 16)
    # An odd element offset leaves only 2-byte loads; 4- and 8-byte ones
    # follow the alignment.
    assert pss.b1_width(64, t[1:1 + 64 * 8].view(8, 64)) == (1, 32)
    assert pss.b1_width(64, t[2:2 + 64 * 8].view(8, 64)) == (2, 32)
    assert pss.b1_width(64, t[4:4 + 64 * 8].view(8, 64)) == (4, 16)
    assert pss.b1_width(7, t[:7].view(1, 7)) == (1, 8)
    # B2's b2_width counts elements and aligns each tensor to its own: 16
    # bytes (8 bf16) a lane where the view allows it, four rows of D = 64
    # per warp load.
    assert pds.b2_width(64, t[:64].view(1, 64), torch.zeros(1, 64)) == (8, 8)
    assert pds.b2_width(128, t[2:130].view(1, 128)) == (2, 32)
    assert pds.b2_width(128, t[4:132].view(1, 128)) == (4, 32)


def test_cpu_bf16_calls_count_no_launch():
    before = (pss.gather_segment_sum.launches,
              pss.gather_segment_sum.launches_bf16,
              pds.dense_sorted_segment_sum.launches_bf16,
              halo.halo_exchange.launches_bf16)
    pss.gather_segment_sum(torch.ones(3, 8, dtype=BF16),
                           torch.zeros(2, dtype=torch.int32),
                           torch.tensor([0, 2], dtype=torch.int32))
    pds.dense_sorted_segment_sum(torch.ones(2, 8, dtype=BF16),
                                 torch.zeros(2, dtype=torch.int32), 1)
    halo.halo_exchange([torch.zeros(1, 2, 8, dtype=BF16)])
    assert before == (pss.gather_segment_sum.launches,
                      pss.gather_segment_sum.launches_bf16,
                      pds.dense_sorted_segment_sum.launches_bf16,
                      halo.halo_exchange.launches_bf16)


def test_b1_builds_one_library_per_table_dtype():
    """The bf16 entry comes from the same source built with its own define,
    a library of its own, so that the two builds run in parallel."""
    f32, b16 = pss.LIBRARY, pss.LIBRARY_BF16
    assert f32.source == b16.source
    assert set(f32.functions) == {"gather_segment_sum_f32"}
    assert set(b16.functions) == {"gather_segment_sum_bf16"}
    assert "-DB1_TABLE_BF16" in b16.flags and "-DB1_TABLE_BF16" not in f32.flags
    assert f32.library_path() != b16.library_path()
    assert b16.library_path().name.startswith("libgather_segment_sum_")
    text = b16.source.read_text()
    assert "#ifndef B1_TABLE_BF16" in text and "gather_segment_sum_bf16" in text
