"""The serving slice end to end: the JAX package's predict_cli and the
port's, on one data directory and one reference-layout checkpoint."""

import jax
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.config import ModelConfig as JConfig
from primekg_rgcn_tpu.data import artifacts as jart
from primekg_rgcn_tpu.data import synthetic as jsyn
from primekg_rgcn_tpu.evaluate import predict_cli as j_cli
from primekg_rgcn_tpu.models.rgcn import init_params
from primekg_rgcn_tpu.train.torch_interop import export_torch_checkpoint
from primekg_rgcn_tpu_torch.evaluate import predict_cli as p_cli


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    raw = jsyn.primekg_like(seed=2, scale=0.03)
    s, t, r = jsyn.bidirect(raw["src"], raw["dst"], raw["rel"])
    jart.save_split_npz(d / "full_graph.npz", {
        "edge_index": np.stack([s, t]), "edge_type": r,
        "num_nodes": raw["num_nodes"], "num_relations": 3})
    jart.save_mappings(d / "mappings.json", jsyn.synthetic_mappings(raw))
    cfg = JConfig(num_nodes=raw["num_nodes"], num_relations=3,
                  embedding_dim=16, hidden_dim=32)
    export_torch_checkpoint(init_params(jax.random.PRNGKey(0), cfg), cfg,
                            d / "model.pt")
    heads = [0, raw["type_ranges"]["drug"][0] + 3,
             raw["type_ranges"]["gene/protein"][0] + 5]
    return d, [str(h) for h in heads]


@pytest.mark.parametrize("relation", [0, 2])
def test_port_cli_matches_jax_cli(served, relation):
    d, heads = served
    argv = ["--model_path", str(d / "model.pt"), "--data_dir", str(d),
            "--heads", *heads, "--relation", str(relation), "--topk", "10"]
    expected = j_cli.main(argv)
    ours = p_cli.main([*argv, "--device", "cpu",
                       "--output", str(d / f"port_{relation}.json")])
    assert len(ours) == len(expected)
    for a, b in zip(ours, expected):
        assert {k: v for k, v in a.items() if k != "predictions"} == {
            k: v for k, v in b.items() if k != "predictions"}
        assert [p["tail_id"] for p in a["predictions"]] == [
            p["tail_id"] for p in b["predictions"]]
        assert [p["tail_name"] for p in a["predictions"]] == [
            p["tail_name"] for p in b["predictions"]]
        np.testing.assert_allclose([p["score"] for p in a["predictions"]],
                                   [p["score"] for p in b["predictions"]],
                                   rtol=2e-4)
    assert (d / f"port_{relation}.json").exists()


def test_cli_defaults_to_cuda_and_refuses_without_a_card(served, monkeypatch):
    d, heads = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        p_cli.main(["--model_path", str(d / "model.pt"), "--data_dir", str(d),
                    "--heads", *heads])


def test_cli_rejects_out_of_range_head(served):
    d, _ = served
    with pytest.raises(SystemExit, match="out of range"):
        p_cli.main(["--model_path", str(d / "model.pt"), "--data_dir", str(d),
                    "--heads", "999999", "--device", "cpu"])
