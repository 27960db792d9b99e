"""The evaluation slice end to end: the JAX package's evaluate CLI and the
port's, on one processed-data directory and one reference-layout ``.pt``.

The ranking blocks (raw, filtered, head and both) depend on no random draw
and agree within 1e-6; the classification block has the same keys (its
negatives come from ``jax.random`` on one side and a ``torch.Generator``
on the other); ``model_info`` is equal. ``--shard node --n_devices 2``
gives the dense ranking blocks within 1e-12, and ``--shard node`` at the
JAX package's shard count (``len(jax.devices())``) the JAX CLI's
``--shard node`` blocks within 1e-6.
"""

import json

import jax
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.config import ModelConfig as JConfig
from primekg_rgcn_tpu.data import artifacts as jart
from primekg_rgcn_tpu.data import synthetic as jsyn
from primekg_rgcn_tpu.evaluate import cli as j_cli
from primekg_rgcn_tpu.models.rgcn import init_params
from primekg_rgcn_tpu.train.torch_interop import export_torch_checkpoint
from primekg_rgcn_tpu_torch.evaluate import cli as p_cli

RANKING = ("ranking", "ranking_filtered", "ranking_head", "ranking_both",
           "ranking_filtered_head", "ranking_filtered_both")
PNGS = ("confusion_matrix.png", "roc_curve.png",
        "precision_recall_curve.png", "score_distribution.png")


def _save(d, name, e, n):
    jart.save_split_npz(d / f"{name}.npz", {
        "edge_index": e[:, :2].T, "edge_type": e[:, 2], "num_nodes": n,
        "num_relations": 3})


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Synthetic splits with the train CLI's drug-gene hold-out, and a
    random model saved as a reference-layout .pt."""
    d = tmp_path_factory.mktemp("eval_cli")
    raw = jsyn.primekg_like(seed=4, scale=0.03)
    n = raw["num_nodes"]
    rng = np.random.default_rng(4)
    dg = np.flatnonzero(raw["rel"] == 0)
    held = rng.choice(dg, size=2 * (len(dg) // 7), replace=False)
    keep = np.ones(len(raw["src"]), bool)
    keep[held] = False

    def bid(rows):
        return np.stack(jsyn.bidirect(raw["src"][rows], raw["dst"][rows],
                                      raw["rel"][rows]), 1)

    _save(d, "train_data", bid(keep), n)
    _save(d, "val_data", bid(held[: len(held) // 2]), n)
    _save(d, "test_data", bid(held[len(held) // 2:]), n)
    _save(d, "full_graph", bid(np.arange(len(raw["src"]))), n)
    cfg = JConfig(num_nodes=n, num_relations=3, embedding_dim=16,
                  hidden_dim=16)
    export_torch_checkpoint(init_params(jax.random.PRNGKey(1), cfg), cfg,
                            d / "model.pt",
                            meta={"epoch": 7, "best_val_loss": 0.625,
                                  "best_val_acc": 0.75})
    return d


def _argv(d, out, *extra):
    return ["--model_path", str(d / "model.pt"), "--data_dir", str(d),
            "--output_dir", str(d / out), "--batch_size", "32",
            "--k_values", "1", "10", *extra]


@pytest.fixture(scope="module")
def both_clis(data):
    extra = ("--filtered", "--rank_direction", "both")
    want = j_cli.main(_argv(data, "jax", *extra))
    got = p_cli.main([*_argv(data, "port", *extra), "--device", "cpu"])
    return want, got


def _close(got, want, tol):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def test_ranking_blocks_match_the_jax_cli(both_clis):
    want, got = both_clis
    assert got.keys() == want.keys()
    assert set(RANKING) <= got.keys()
    for block in RANKING:
        _close(got[block], want[block], 1e-6)
    assert (got["test_edges"], got["num_nodes"]) == (
        want["test_edges"], want["num_nodes"])


def test_classification_block_and_model_info_match(both_clis, data):
    want, got = both_clis
    assert got["classification"].keys() == want["classification"].keys()
    assert np.isfinite(list(got["classification"].values())).all()
    pj = json.loads((data / "jax" / "results.json").read_text())
    pp = json.loads((data / "port" / "results.json").read_text())
    assert pp["model_info"] == pj["model_info"]
    assert pp["model_info"]["epoch"] == 7
    assert pp["metrics"].keys() == pj["metrics"].keys()
    summary = (data / "port" / "metrics_summary.txt").read_text()
    assert "Filtered Head+Tail Ranking Metrics" in summary
    assert (data / "port" / "evaluation.log").exists()


def test_node_shard_gives_the_dense_ranking(both_clis, data):
    _, dense = both_clis
    got = p_cli.main([*_argv(data, "port_node", "--rank_direction", "both"),
                      "--device", "cpu", "--shard", "node",
                      "--n_devices", "2"])
    for block in ("ranking", "ranking_head", "ranking_both"):
        _close(got[block], dense[block], 1e-12)
    assert "ranking_filtered" not in got


def test_node_shard_matches_the_jax_cli(data):
    argv = ("--rank_direction", "both", "--shard", "node")
    want = j_cli.main(_argv(data, "jax_node", *argv))
    got = p_cli.main([*_argv(data, "port_node_jax", *argv), "--device",
                      "cpu", "--n_devices", str(len(jax.devices()))])
    assert got.keys() == want.keys()
    for block in ("ranking", "ranking_head", "ranking_both"):
        _close(got[block], want[block], 1e-6)
    assert got["classification"].keys() == want["classification"].keys()


def test_writes_the_four_pngs(both_clis, data):
    pytest.importorskip("matplotlib")
    for name in PNGS:
        assert (data / "port" / name).stat().st_size > 0


def test_without_matplotlib_the_results_are_still_written(
        data, monkeypatch, caplog):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("no matplotlib")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with caplog.at_level("INFO"):
        p_cli.main([*_argv(data, "port_nompl"), "--device", "cpu"])
    out = data / "port_nompl"
    assert (out / "results.json").exists()
    assert (out / "metrics_summary.txt").exists()
    assert not any((out / name).exists() for name in PNGS)
    assert "PNGs were not written" in caplog.text


def test_cli_defaults_to_cuda_and_refuses_without_a_card(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        p_cli.main(_argv(data, "port_cuda"))


def test_filtered_with_node_shard_is_refused_at_parse_time(data):
    with pytest.raises(SystemExit):
        p_cli.parse_args(_argv(data, "x", "--filtered", "--shard", "node",
                               "--n_devices", "2", "--device", "cpu"))
    assert not (data / "x").exists()


def test_node_shard_needs_two_shards(data):
    with pytest.raises(SystemExit, match="at least 2 shards"):
        p_cli.main([*_argv(data, "port_one"), "--device", "cpu", "--shard",
                    "node"])
