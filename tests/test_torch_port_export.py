"""The serving artifact: ``predict_cli --export`` writes a ``torch.export``
program of the top-K scorer over the frozen embeddings, which loads with
torch alone. Its scores are within rtol 1e-5 of the JAX package's
StableHLO export (``export_topk_predictor`` / ``load_predictor``) on the
same parameters, its ids equal on untied entries, and it reproduces the
CLI's own top-K."""

import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.config import ModelConfig as JConfig
from primekg_rgcn_tpu.data import artifacts as jart
from primekg_rgcn_tpu.data import synthetic as jsyn
from primekg_rgcn_tpu.evaluate import export as j_export
from primekg_rgcn_tpu.evaluate import predict_cli as j_cli
from primekg_rgcn_tpu.models.rgcn import init_params
from primekg_rgcn_tpu.train.torch_interop import export_torch_checkpoint
from primekg_rgcn_tpu_torch.evaluate import export as p_export
from primekg_rgcn_tpu_torch.evaluate import predict_cli as p_cli
from port_analysis_data import one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


BATCH, TOPK = 8, 6


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """One model and data directory; the JAX and the port CLI each serve
    three heads and write their artifact."""
    d = tmp_path_factory.mktemp("export")
    raw = jsyn.primekg_like(seed=3, scale=0.03)
    s, t, r = jsyn.bidirect(raw["src"], raw["dst"], raw["rel"])
    jart.save_split_npz(d / "full_graph.npz", {
        "edge_index": np.stack([s, t]), "edge_type": r,
        "num_nodes": raw["num_nodes"], "num_relations": 3})
    cfg = JConfig(num_nodes=raw["num_nodes"], num_relations=3,
                  embedding_dim=16, hidden_dim=32)
    export_torch_checkpoint(init_params(jax.random.PRNGKey(5), cfg), cfg,
                            d / "model.pt")
    argv = ["--model_path", str(d / "model.pt"), "--data_dir", str(d),
            "--heads", "0", "11", "300", "--relation", "1", "--topk",
            str(TOPK), "--export_batch", str(BATCH)]
    j_cli.main([*argv, "--export", str(d / "jax.stablehlo")])
    served = p_cli.main([*argv, "--export", str(d / "port.pt2"),
                         "--device", "cpu"])
    return d, raw["num_nodes"], served


def _queries(n):
    rng = np.random.default_rng(0)
    return rng.integers(0, n, BATCH), rng.integers(0, 3, BATCH)


def _untied(scores, rtol=1e-5):
    """Entries whose neighbours in the row are further apart than rtol of
    the row's largest |score|."""
    tol = rtol * np.abs(scores).max(1, keepdims=True)
    gaps = np.abs(np.diff(scores, axis=1)) > tol
    keep = np.ones(scores.shape, bool)
    keep[:, 1:] &= gaps
    keep[:, :-1] &= gaps
    return keep


def test_export_matches_the_jax_export(exported):
    d, n, _ = exported
    heads, rels = _queries(n)
    want_s, want_t = j_export.load_predictor(d / "jax.stablehlo")(heads, rels)
    got_s, got_t = p_export.load_predictor(d / "port.pt2")(
        torch.as_tensor(heads), torch.as_tensor(rels))
    assert got_s.shape == (BATCH, TOPK) and got_t.dtype == torch.int64
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=1e-7)
    keep = _untied(want_s)
    assert keep.mean() > 0.5
    np.testing.assert_array_equal(got_t.numpy()[keep], want_t[keep])


def test_export_reproduces_the_cli_top_k(exported):
    d, _, served = exported
    heads = torch.zeros(BATCH, dtype=torch.long)
    heads[:3] = torch.tensor([q["head_id"] for q in served])
    scores, tails = p_export.load_predictor(d / "port.pt2")(
        heads, torch.ones(BATCH, dtype=torch.long))
    for qi, q in enumerate(served):
        assert tails[qi].tolist() == [p["tail_id"] for p in q["predictions"]]
        np.testing.assert_array_equal(
            scores[qi].numpy(),
            np.float32([p["score"] for p in q["predictions"]]))


def test_export_loads_with_torch_alone(exported, tmp_path):
    d, n, _ = exported
    heads, rels = _queries(n)
    code = (
        "import json, sys, torch\n"
        f"m = torch.export.load({str(d / 'port.pt2')!r}).module()\n"
        f"s, t = m(torch.tensor({heads.tolist()}), "
        f"torch.tensor({rels.tolist()}))\n"
        "print(json.dumps({'tails': t.tolist(), 'port': [k for k in "
        "sys.modules if k.startswith('primekg')]}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["port"] == []
    _, want = p_export.load_predictor(d / "port.pt2")(
        torch.as_tensor(heads), torch.as_tensor(rels))
    assert out["tails"] == want.tolist()


def test_export_of_given_tables_is_their_top_k(tmp_path):
    gen = torch.Generator().manual_seed(0)
    node, rel = torch.randn(40, 8, generator=gen), torch.randn(3, 8,
                                                              generator=gen)
    path = p_export.export_topk_predictor(node, rel, tmp_path / "a.pt2",
                                          batch_size=4, topk=5)
    heads, rels = torch.tensor([0, 1, 2, 3]), torch.tensor([0, 2, 1, 0])
    got = p_export.load_predictor(path)(heads, rels)
    want = torch.topk((node[heads] * rel[rels]) @ node.T, 5, dim=1)
    assert torch.equal(got[0], want.values)
    assert torch.equal(got[1], want.indices)


def test_export_with_shard_node_is_refused(exported):
    d, _, _ = exported
    with pytest.raises(SystemExit):
        p_cli.main(["--model_path", str(d / "model.pt"), "--data_dir",
                    str(d), "--heads", "0", "--device", "cpu", "--shard",
                    "node", "--n_devices", "2", "--export",
                    str(d / "never.pt2")])
    assert not (d / "never.pt2").exists()
