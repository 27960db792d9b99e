"""The port's flax-free msgpack codec (``train/flax_msgpack.py``) against
flax's own ``serialization``: every leaf type and value kind a checkpoint
holds, restored leaf for leaf and written back byte for byte; the optax
state after one adam step written byte for byte; chunked leaves read and
written byte for byte with both packages' ``MAX_CHUNK_SIZE`` set small;
the refusals. Leaves are compared exactly (bf16 through float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from primekg_rgcn_tpu.train.loop import TrainState
from primekg_rgcn_tpu_torch.train import flax_msgpack as fm

RNG = np.random.default_rng(0)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


LEAVES = {
    "f32": RNG.standard_normal((3, 5)).astype(np.float32),
    "f64": RNG.standard_normal(70),
    "bf16": _bf16(RNG.standard_normal((4, 6))),
    "int32": RNG.integers(-2 ** 31, 2 ** 31, (300,)).astype(np.int32),
    "uint32": RNG.integers(0, 2 ** 32, (2, 9)).astype(np.uint32),
    "int64": np.arange(-5, 5, dtype=np.int64),
    "uint8": np.arange(256, dtype=np.uint8),
    "bool": RNG.random((3, 4)) < 0.5,
    "zero_d": np.zeros((), np.int32),
    "zero_d_f32": np.asarray(3.25, np.float32),
    "empty": np.zeros((0, 3), np.float32),
    "big": RNG.standard_normal((20, 40)).astype(np.float32),  # bin16
    "np_f32": np.float32(2.5),
    "np_i64": np.int64(-7),
    "np_bool": np.bool_(True),
    "np_bf16": _bf16(1.5)[()],
}
VALUES = {
    "inf": float("inf"), "ninf": -float("inf"), "pi": 3.141592653589793,
    "none": None, "true": True, "false": False, "short": "x",
    "str8": "y" * 40, "str16": "z" * 300, "empty_dict": {},
    **{f"int{i}": v for i, v in enumerate(
        [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
         2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
         -2 ** 31 - 1, -2 ** 63])},
    "map16": {str(i): i for i in range(20)},
    "nested": {"a": {"b": {"c": np.ones(2, np.float32), "d": {}}}},
}


def _same(ours, theirs, where=""):
    """``ours`` (restored by the port) equals flax's ``msgpack_restore``."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and list(ours) == list(theirs), where
        for k in theirs:
            _same(ours[k], theirs[k], f"{where}/{k}")
    elif isinstance(theirs, (np.ndarray, np.generic)):
        assert isinstance(ours, torch.Tensor), where
        theirs = np.asarray(theirs)
        assert tuple(ours.shape) == theirs.shape, where
        if theirs.dtype.name == "bfloat16":
            assert ours.dtype == torch.bfloat16, where
            ours, theirs = ours.float(), theirs.astype(np.float32)
        else:
            assert str(ours.dtype).endswith(theirs.dtype.name), where
        np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=where)
    else:
        assert type(ours) is type(theirs) and ours == theirs, where


@pytest.mark.parametrize("name", [*LEAVES, *VALUES])
def test_restore_and_serialize_match_flax(name):
    tree = {"leaf": {**LEAVES, **VALUES}[name], "tail": 1}
    blob = serialization.to_bytes(tree)
    restored = fm.restore(blob)
    _same(restored, serialization.msgpack_restore(blob))
    assert fm.serialize(tree) == blob
    if name not in ("np_f32", "np_i64", "np_bool", "np_bf16"):
        # A restored tree writes back the same bytes (numpy scalars come
        # back as 0-d tensors, written as arrays).
        assert fm.serialize(restored) == blob


def test_every_leaf_in_one_tree_and_on_a_device():
    tree = {**LEAVES, **VALUES}
    blob = serialization.to_bytes(tree)
    _same(fm.restore(blob, device="cpu"), serialization.msgpack_restore(blob))
    assert fm.serialize(tree) == blob


def _adam_state(n_steps):
    rng = np.random.default_rng(1)
    params = {"encoder": {"node_emb": rng.standard_normal((7, 4)),
                          "conv1": {"w_rel": rng.standard_normal((2, 4, 3)),
                                    "bias": np.zeros(3)}},
              "decoder": {"rel_emb": rng.standard_normal((2, 3))}}
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                    params)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.scale_by_adam(),
                      optax.scale(-1e-2))
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    for _ in range(n_steps):
        grads = jax.tree_util.tree_map(jnp.sin, state.params)
        upd, o = opt.update(grads, state.opt_state, state.params)
        state = TrainState(optax.apply_updates(state.params, upd), o,
                           state.step + 1)
    return state


@pytest.mark.parametrize("n_steps", [0, 1])
def test_adam_state_round_trips_byte_for_byte(n_steps):
    """The state before a step (params in init order) and after one (JAX
    rebuilds every dict sorted): restored leaf for leaf, written back byte
    for byte."""
    state = _adam_state(n_steps)
    blob = serialization.to_bytes(state)
    restored = fm.restore(blob)
    _same(restored, serialization.msgpack_restore(blob))
    assert list(restored) == ["params", "opt_state", "step"]
    assert fm.serialize(restored) == blob
    assert int(restored["step"]) == n_steps
    assert restored["opt_state"]["1"]["count"].dtype == torch.int32


@pytest.mark.parametrize("chunk", [3, 16, 100, 1000])
def test_chunked_leaves_read_and_write_byte_for_byte(chunk, monkeypatch,
                                                     tmp_path):
    """flax splits a leaf above ``MAX_CHUNK_SIZE`` bytes into flat chunks
    (config 5's table and moments at the real constant); with both
    packages' constants set small, the port reads flax's chunked file and
    writes it again byte for byte, to bytes and to a file."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", chunk)
    state = _adam_state(1)
    tree = {"state": jax.tree_util.tree_map(
                np.asarray, serialization.to_state_dict(state)),
            "table": np.arange(400, dtype=np.float32).reshape(50, 8),
            "bf16": _bf16(np.arange(37.0)), "bool": np.ones(50, bool),
            "scalar": np.float32(1.0)}
    blob = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in blob
    restored = fm.restore(blob)
    _same(restored, serialization.msgpack_restore(blob))
    _same(fm.restore(bytearray(blob), device="cpu"),
          serialization.msgpack_restore(blob))
    assert fm.serialize(tree) == blob
    with open(tmp_path / "t.msgpack", "wb") as f:
        fm.write(tree, f)
    assert (tmp_path / "t.msgpack").read_bytes() == blob


def test_restore_views_its_buffer_and_copies_to_a_device():
    blob = bytearray(serialization.to_bytes(
        {"a": np.arange(6, dtype=np.int32)}))
    view = fm.restore(blob)["a"]
    copy = fm.restore(blob, device="cpu")["a"]
    view[0] = 41
    assert int(fm.restore(blob)["a"][0]) == 41
    assert int(copy[0]) == 0


@pytest.mark.parametrize("blob,match", [
    (b"\xd4\x02\x00", "complex"),
    (b"\xd4\x09\x00", "unknown msgpack ext"),
    (b"\x82\xa1a", "truncated"),
    (b"\xc1", "invalid msgpack"),
    (b"\xc0\xc0", "trailing"),
])
def test_refusals(blob, match):
    if match == "complex":
        blob = serialization.to_bytes({"c": 1 + 2j})
    with pytest.raises(ValueError, match=match):
        fm.restore(blob)


def test_serialize_refuses_what_flax_cannot_write():
    with pytest.raises(TypeError):
        fm.serialize({"x": object()})
    with pytest.raises(ValueError):
        fm.serialize({"x": np.ones(2, np.complex64)})
