"""The port's model and checkpoint interop against the JAX package, on
parameters carried across with ``params_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.config import ModelConfig as JConfig
from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.models import rgcn as jmodel
from primekg_rgcn_tpu.train.torch_interop import export_torch_checkpoint
from primekg_rgcn_tpu_torch.config import ModelConfig
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.models import rgcn as pmodel
from primekg_rgcn_tpu_torch.train import checkpoint as pckpt
from primekg_rgcn_tpu_torch.train import torch_interop as pinterop


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(params):
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _leaves(params[k])
    else:
        yield params


def test_default_config_parameter_count():
    cfg = ModelConfig(num_nodes=30926, num_relations=3)
    params = pmodel.init_params(torch.Generator().manual_seed(0), cfg)
    assert pmodel.count_params(params) == 2_078_208


@pytest.mark.parametrize("bases", [None, 2])
def test_parameter_layout_matches_jax(bases):
    jp = jmodel.init_params(jax.random.PRNGKey(0),
                            JConfig(num_nodes=40, num_relations=3, num_bases=bases))
    pp = pmodel.init_params(torch.Generator().manual_seed(0),
                            ModelConfig(num_nodes=40, num_relations=3,
                                        num_bases=bases))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == len(list(_leaves(pp)))
    for path, leaf in jflat:
        node = pp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.float32
    assert pmodel.count_params(pp) == jmodel.count_params(jp)


def test_init_is_seeded_and_bounded():
    cfg = ModelConfig(num_nodes=30, num_relations=3, embedding_dim=8,
                      hidden_dim=16)
    a = pmodel.init_params(torch.Generator().manual_seed(3), cfg)
    b = pmodel.init_params(torch.Generator().manual_seed(3), cfg)
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)
    limit = (6.0 / (30 + 8)) ** 0.5
    assert a["encoder"]["node_emb"].abs().max() <= limit


def test_bfloat16_compute_is_accepted():
    cfg = ModelConfig(num_nodes=4, num_relations=1, compute_dtype="bfloat16")
    assert cfg.compute_dtype == "bfloat16"
    assert pmodel.compute_dtype(cfg) == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        ModelConfig(num_nodes=4, num_relations=1, compute_dtype="float16")
    assert ModelConfig.from_dict({**cfg.to_dict(), "extra": 1}) == cfg


@pytest.mark.parametrize("norm", ["dense", "edge"])
def test_predict_all_tails_matches_jax(norm):
    rng = np.random.default_rng(5)
    n, r, e = 60, 3, 700
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    rel = rng.integers(0, r, e)
    jcfg = JConfig(num_nodes=n, num_relations=r, embedding_dim=8,
                   hidden_dim=16)
    jp = jmodel.init_params(jax.random.PRNGKey(3), jcfg)
    jg = j_build(src, dst, rel, n, r, bucket_pad_multiple=64, norm=norm,
                 use_native="never")
    heads = rng.integers(0, n, 12)
    tails = rng.integers(0, n, 12)
    rels = rng.integers(0, r, 12)
    expected = np.asarray(jmodel.predict_all_tails(
        jp, jg, jnp.asarray(heads), jnp.asarray(rels), jcfg))
    expected_pred = np.asarray(jmodel.predict(
        jp, jg, jnp.asarray(heads), jnp.asarray(tails), jnp.asarray(rels),
        jcfg))
    expected_emb = np.asarray(jmodel.get_embeddings(jp, jg, jcfg))

    cfg = ModelConfig.from_dict(jcfg.to_dict())
    pp = pinterop.params_from_jax(_np_tree(jp))
    pg = p_build(src, dst, rel, n, r, bucket_pad_multiple=64, norm=norm)
    th, tt, tr = (torch.from_numpy(a) for a in (heads, tails, rels))
    ours = pmodel.predict_all_tails(pp, pg, th, tr, cfg)
    np.testing.assert_allclose(ours.numpy(), expected, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(pmodel.predict(pp, pg, th, tt, tr, cfg).numpy(),
                               expected_pred, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(pmodel.get_embeddings(pp, pg, cfg).numpy(),
                               expected_emb, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("bases", [None, 2])
def test_reference_pt_round_trip_and_jax_export(tmp_path, bases):
    jcfg = JConfig(num_nodes=20, num_relations=3, embedding_dim=8,
                   hidden_dim=16, num_bases=bases, dropout=0.3)
    jp = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    export_torch_checkpoint(jp, jcfg, tmp_path / "jax.pt", {"epoch": 7})
    payload = pckpt.load(tmp_path / "jax.pt")
    assert payload["epoch"] == 7
    cfg = ModelConfig.from_dict(payload["model_config"])
    assert cfg.to_dict() == jcfg.to_dict()
    expected = pinterop.params_from_jax(_np_tree(jp))
    for a, b in zip(_leaves(payload["params"]), _leaves(expected)):
        assert torch.equal(a, b)

    pinterop.save_reference_pt(payload["params"], cfg, tmp_path / "port.pt")
    again, cfg2, _ = pinterop.load_reference_pt(tmp_path / "port.pt")
    assert cfg2 == cfg
    for a, b in zip(_leaves(again), _leaves(expected)):
        assert torch.equal(a, b)


def test_checkpoint_rejects_jax_native_format(tmp_path):
    """A JAX checkpoint loads whole (tests/test_torch_port_jax_checkpoint.
    py); one whose .msgpack is missing is refused, naming it."""
    (tmp_path / "ckpt.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match=r"ckpt\.msgpack"):
        pckpt.load(tmp_path / "ckpt")
