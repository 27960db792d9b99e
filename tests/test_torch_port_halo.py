"""Kernel B4's module, the halo exchange, against the JAX package's: its
schedule, the plain exchange against ``lax.all_to_all`` and the Pallas
kernel (interpret mode on the CPU mesh), and ``HaloExchange``'s gradient
against the JAX VJP. An exchange only moves floats, so results are exact
and gradients hold at rtol 1e-5 (the JAX VJP test's tolerance)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from primekg_rgcn_tpu.ops.pallas.halo import halo_schedule as j_schedule
from primekg_rgcn_tpu.ops.pallas.halo import pallas_halo_exchange
from primekg_rgcn_tpu.parallel.mesh import make_mesh as j_mesh
from primekg_rgcn_tpu_torch.ops.cuda import halo
from primekg_rgcn_tpu_torch.parallel import mesh as pmesh


@pytest.mark.parametrize("n", range(1, 9))
def test_schedule_equals_jax(n):
    """The schedule is JAX's, and the kernel's grid steps walk each shard's
    peers in its order: transfer i of shard s to (s + 1 + i) % n, then the
    local slot, each step a permutation of the shards."""
    assert halo.halo_schedule(n) == j_schedule(n)
    offsets = halo.step_offsets(n)
    assert sorted(offsets) == list(range(n))
    for s in range(n):
        assert [(s + o) % n for o in offsets] == [
            (s + 1 + i) % n for kind, i in j_schedule(n)
            if kind == "start"] + [s]


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

    return np.asarray(run(jnp.asarray(send)))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_plain_exchange_equals_all_to_all_and_the_pallas_kernel(impl):
    n, p, d = 4, 8, 128
    send = np.random.default_rng(0).normal(size=(n, n, p, d)).astype(
        np.float32)
    expected = _jax_exchange(send, impl)
    sends = [torch.from_numpy(send[i]) for i in range(n)]
    for fn in (halo.halo_exchange_plain, halo.halo_exchange):
        got = np.stack([r.numpy() for r in fn(sends)])
        np.testing.assert_array_equal(got, expected)


def test_gradient_matches_the_jax_vjp():
    """d/dsend of sum_d sum(recv_d * w_d * recv_d), the nonlinear loss of
    the JAX package's VJP test: through ``HaloExchange`` (the exchange on
    the gradients) and through autograd over the plain version."""
    n, p, d = 4, 4, 32
    rng = np.random.default_rng(3)
    send = rng.normal(size=(n, n, p, d)).astype(np.float32)
    weight = rng.normal(size=(n, n, p, d)).astype(np.float32)

    @jax.jit
    @partial(jax.shard_map, mesh=j_mesh(n), in_specs=(P("data"),) * 2,
             out_specs=P("data"), check_vma=False)
    def j_grad(s, w):
        def loss(x):
            r = pallas_halo_exchange(x[0], "data")
            return jnp.sum(r * w[0] * r)
        return jax.grad(loss)(s)

    expected = np.asarray(j_grad(jnp.asarray(send), jnp.asarray(weight)))
    for exchange in (lambda s: halo.HaloExchange.apply(*s),
                     halo.halo_exchange_plain):
        sends = [torch.from_numpy(send[i]).requires_grad_(True)
                 for i in range(n)]
        recvs = exchange(sends)
        sum(torch.sum(r * torch.from_numpy(weight[i]) * r)
            for i, r in enumerate(recvs)).backward()
        got = np.stack([s.grad.numpy() for s in sends])
        np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)


def test_an_unused_output_gets_a_zero_gradient():
    rng = np.random.default_rng(1)
    sends = [torch.from_numpy(rng.normal(size=(3, 2, 5)).astype(np.float32))
             .requires_grad_(True) for _ in range(3)]
    recvs = halo.HaloExchange.apply(*sends)
    recvs[1].sum().backward()    # only shard 1's recv: send[d][1] for all d
    for s in sends:
        want = torch.zeros(3, 2, 5)
        want[1] = 1.0
        assert torch.equal(s.grad, want)


@pytest.mark.parametrize("case", ["dtype", "shape", "count", "lead",
                                  "strided", "grad"])
def test_wrapper_refuses_malformed_sends(case):
    sends = [torch.zeros(2, 3, 4) for _ in range(2)]
    if case == "dtype":
        sends[1] = sends[1].double()
    elif case == "shape":
        sends[1] = torch.zeros(2, 4, 4)
    elif case == "count":
        sends.append(torch.zeros(2, 3, 4))
    elif case == "lead":
        sends = [torch.zeros(3, 3, 4) for _ in range(2)]
    elif case == "strided":
        sends[0] = torch.zeros(2, 3, 8)[:, :, ::2]
    else:
        sends[0].requires_grad_(True)
    with pytest.raises(ValueError):
        halo.halo_exchange(sends)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    before = halo.halo_exchange.launches
    sends = [torch.randn(2, 3, 4) for _ in range(2)]
    recvs = halo.halo_exchange(sends)
    assert halo.halo_exchange.launches == before
    assert torch.equal(recvs[1][0], sends[0][1])
    assert recvs[0].data_ptr() != recvs[1].data_ptr()


def test_mesh_collectives_and_its_size_floor():
    mesh = pmesh.make_mesh(3, "cpu")
    assert (mesh.n_shards, mesh.device.type) == (3, "cpu")
    xs = [torch.full((2,), float(i)) for i in range(3)]
    assert torch.equal(pmesh.psum(xs), torch.full((2,), 3.0))
    assert torch.equal(pmesh.all_gather(xs), torch.stack(xs))
    for n in (None, 1):
        with pytest.raises(ValueError, match="at least 2 shards"):
            pmesh.make_mesh(n, "cpu")
