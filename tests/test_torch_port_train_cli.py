"""The training slice end to end on the CPU: the port's train CLI on a small
synthetic graph, its splits against the JAX CLI's, its checkpoint read by
the JAX package, and resume."""

import argparse
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.config import ModelConfig as JModelConfig
from primekg_rgcn_tpu.data import artifacts as jart
from primekg_rgcn_tpu.models import rgcn as jmodel
from primekg_rgcn_tpu.train import checkpoint as jckpt
from primekg_rgcn_tpu.train import cli as jcli
from primekg_rgcn_tpu_torch.config import ModelConfig
from primekg_rgcn_tpu_torch.data import artifacts as part
from primekg_rgcn_tpu_torch.models import rgcn as pmodel
from primekg_rgcn_tpu_torch.train import checkpoint as pckpt
from primekg_rgcn_tpu_torch.train import cli as pcli

ARGS = ["--synthetic", "--synthetic_scale", "0.02", "--epochs", "2",
        "--embedding_dim", "8", "--hidden_dim", "8", "--batch_size", "64",
        "--lr", "0.01", "--save_every", "1", "--seed", "3"]
SPLITS = ["train_data", "val_data", "test_data", "full_graph"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_train")
    result = pcli.main([*ARGS, "--output_dir", str(out), "--device", "cpu"])
    return out, result


def test_synthetic_splits_equal_the_jax_cli(trained, tmp_path):
    out, _ = trained
    jargs = jcli.parse_args([*ARGS, "--output_dir", str(tmp_path)])
    jcli._load_graphs(jargs)
    for name in SPLITS:
        ours = out / "synthetic_data" / f"{name}.npz"
        theirs = tmp_path / "synthetic_data" / f"{name}.npz"
        # The zip container stamps each member with the time it was written;
        # every member's bytes (the .npy payloads) must be equal.
        with zipfile.ZipFile(ours) as a, zipfile.ZipFile(theirs) as b:
            assert a.namelist() == b.namelist()
            for member in a.namelist():
                assert a.read(member) == b.read(member), (name, member)
    assert ((out / "synthetic_data" / "mappings.json").read_bytes()
            == (tmp_path / "synthetic_data" / "mappings.json").read_bytes())


def test_cli_writes_metrics_and_checkpoints_and_the_loss_falls(trained):
    out, result = trained
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2
    hist = result["history"]
    assert len(hist["train_losses"]) == 2
    assert hist["train_losses"][1] < hist["train_losses"][0]
    assert all(np.isfinite(hist["val_losses"]))
    for f in ("models/best_model.pt", "models/final_model.pt",
              "checkpoints/checkpoint_epoch_1.pt",
              "checkpoints/checkpoint_epoch_2.pt", "training.log"):
        assert (out / f).exists(), f
    blob = torch.load(out / "models/final_model.pt", weights_only=False)
    assert isinstance(blob["args"], argparse.Namespace)
    assert isinstance(blob["model_config"], dict)
    assert isinstance(blob["train_config"], dict)
    assert blob["epoch"] == 2 and blob["history"] == hist
    assert {"model_state_dict", "optimizer_state_dict", "best_val_loss",
            "best_val_acc", "rng_state", "device_rng_state"} <= blob.keys()
    # Nothing of the port is pickled: a reader without it can unpickle.
    with zipfile.ZipFile(out / "models/final_model.pt") as z:
        pickled = [z.read(m) for m in z.namelist() if m.endswith(".pkl")]
    assert pickled and not any(b"primekg_rgcn_tpu" in p for p in pickled)


def test_jax_package_reads_the_port_checkpoint_and_predicts_the_same(trained):
    out, _ = trained
    payload = jckpt.load(out / "models" / "final_model.pt")
    jcfg = JModelConfig.from_dict(payload["model_config"])
    assert payload["epoch"] == 2
    full = jart.load_split(out / "synthetic_data" / "full_graph.npz")
    jg = jart.split_to_rel_graph(full)
    rng = np.random.default_rng(0)
    h, t = rng.integers(0, jcfg.num_nodes, (2, 32))
    r = rng.integers(0, jcfg.num_relations, 32)
    expected = np.asarray(jmodel.predict(payload["state"].params, jg,
                                         jnp.asarray(h), jnp.asarray(t),
                                         jnp.asarray(r), jcfg))

    ours = pckpt.load(out / "models" / "final_model.pt")
    cfg = ModelConfig.from_dict(ours["model_config"])
    assert cfg.to_dict() == jcfg.to_dict()
    pg = part.split_to_rel_graph(part.load_split(
        out / "synthetic_data" / "full_graph.npz"))
    with torch.no_grad():
        got = pmodel.predict(ours["params"], pg, *(torch.from_numpy(a)
                                                   for a in (h, t, r)), cfg)
    scale = float(np.abs(expected).max())
    np.testing.assert_allclose(got.numpy(), expected, rtol=2e-4,
                               atol=2e-5 * scale)


def test_resume_continues_epochs_history_and_streams(trained, tmp_path):
    out, result = trained
    resumed = pcli.main([*ARGS, "--output_dir", str(tmp_path),
                         "--device", "cpu", "--resume",
                         str(out / "checkpoints" / "checkpoint_epoch_1.pt")])
    hist, want = resumed["history"], result["history"]
    assert len(hist["train_losses"]) == 2
    assert hist["train_losses"][0] == want["train_losses"][0]
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 1
    # Parameters, optimizer and both generators restored: epoch 2 repeats.
    for k in want:
        np.testing.assert_allclose(hist[k][1], want[k][1], rtol=1e-5)
    assert pckpt.load(tmp_path / "models" / "final_model.pt")["epoch"] == 2


def test_cli_defaults_to_cuda_and_refuses_without_a_card(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pcli.main([*ARGS, "--output_dir", str(tmp_path)])
    assert not (tmp_path / "synthetic_data").exists()
