"""Reference ``.pt`` checkpoints and parameters from the JAX package.

The reference pipeline saves torch pickles of its model's state dict
(``{'model_state_dict': ..., 'args': argparse.Namespace, ...}``), laid out
as PyG's RGCNConv keeps its weights:

    encoder.node_embeddings.weight     [N, d_emb]
    encoder.conv{1,2}.weight           [R, Din, Dout]  (or [B, Din, Dout] with
    encoder.conv{1,2}.comp             [R, B]           basis decomposition)
    encoder.conv{1,2}.root             [Din, Dout]
    encoder.conv{1,2}.bias             [Dout]
    decoder.relation_embeddings.weight [R, d_h]

Both layouts use x @ W conventions, so tensors map without transposition.
The JAX package exports the same layout. Its own checkpoints
(``stem.msgpack`` + ``stem.json``) load directly (``train/checkpoint``);
:func:`main` converts between the two layouts, as the JAX module's CLI
does, with no JAX installed::

    python -m primekg_rgcn_tpu_torch.train.torch_interop import ref.pt out_ckpt
    python -m primekg_rgcn_tpu_torch.train.torch_interop export ckpt out.pt

The configuration is rebuilt from the parameter shapes and the ``args``
namespace, and its ``compute_dtype`` from the file's ``model_config`` dict
when the file has one (the port's trainer and :func:`save_reference_pt`
write it); a file without it, as the reference and the JAX package write
them, loads at float32. The JAX package reads a port file at float32
whatever its ``model_config`` says.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from primekg_rgcn_tpu_torch.config import ModelConfig
from primekg_rgcn_tpu_torch.models.rgcn import Params, params_to


def _conv_from_state(sd: Dict[str, Any], prefix: str) -> Params:
    def get(name):
        return torch.as_tensor(sd[f"{prefix}.{name}"],
                               dtype=torch.float32).detach().cpu()

    conv: Params = {"w_root": get("root"), "bias": get("bias")}
    if f"{prefix}.comp" in sd:
        conv["basis"] = get("weight")
        conv["coef"] = get("comp")
    else:
        conv["w_rel"] = get("weight")
    return conv


def params_from_state_dict(sd: Dict[str, Any]) -> Params:
    """Reference state dict -> parameter dict (CPU tensors)."""
    return {
        "encoder": {
            "node_emb": torch.as_tensor(
                sd["encoder.node_embeddings.weight"],
                dtype=torch.float32).detach().cpu(),
            "conv1": _conv_from_state(sd, "encoder.conv1"),
            "conv2": _conv_from_state(sd, "encoder.conv2"),
        },
        "decoder": {"rel_emb": torch.as_tensor(
            sd["decoder.relation_embeddings.weight"],
            dtype=torch.float32).detach().cpu()},
    }


def state_dict_from_params(params: Params) -> Dict[str, torch.Tensor]:
    """Parameter dict -> reference state dict (CPU tensors)."""
    def t(x):
        return x.detach().cpu().clone()

    enc = params["encoder"]
    sd: Dict[str, torch.Tensor] = {
        "encoder.node_embeddings.weight": t(enc["node_emb"]),
        "decoder.relation_embeddings.weight": t(params["decoder"]["rel_emb"]),
    }
    for name in ("conv1", "conv2"):
        conv = enc[name]
        sd[f"encoder.{name}.root"] = t(conv["w_root"])
        sd[f"encoder.{name}.bias"] = t(conv["bias"])
        if "w_rel" in conv:
            sd[f"encoder.{name}.weight"] = t(conv["w_rel"])
        else:
            sd[f"encoder.{name}.weight"] = t(conv["basis"])
            sd[f"encoder.{name}.comp"] = t(conv["coef"])
    return sd


def config_from_params(params: Params, args=None,
                       compute_dtype: str = "float32") -> ModelConfig:
    """Rebuild the ModelConfig from parameter shapes (plus the dropout
    rates stored in the reference's argparse namespace, if any)."""
    num_nodes, embedding_dim = params["encoder"]["node_emb"].shape
    num_relations, hidden_dim = params["decoder"]["rel_emb"].shape
    conv1 = params["encoder"]["conv1"]
    num_bases = int(conv1["basis"].shape[0]) if "basis" in conv1 else None
    return ModelConfig(
        num_nodes=int(num_nodes), num_relations=int(num_relations),
        embedding_dim=int(embedding_dim), hidden_dim=int(hidden_dim),
        dropout=float(getattr(args, "dropout", 0.5)),
        decoder_dropout=float(getattr(args, "decoder_dropout", 0.0)),
        num_bases=num_bases, compute_dtype=compute_dtype)


def load_reference_pt(path, *, device="cpu"
                      ) -> Tuple[Params, ModelConfig, Dict[str, Any]]:
    """Load a reference-layout checkpoint -> (params, ModelConfig, meta).

    Accepts full trainer checkpoints ({'model_state_dict': ..., 'args': ...})
    and bare state dicts. ``meta`` keeps the scalar entries. The file is a
    pickle: load only trusted checkpoints.
    """
    blob = torch.load(path, map_location="cpu", weights_only=False)
    return reference_from_blob(blob, device=device)


def reference_from_blob(blob, *, device="cpu"
                        ) -> Tuple[Params, ModelConfig, Dict[str, Any]]:
    """:func:`load_reference_pt` on an already unpickled checkpoint."""
    if isinstance(blob, dict) and "model_state_dict" in blob:
        sd = blob["model_state_dict"]
        meta = {k: v for k, v in blob.items() if k != "model_state_dict"}
    else:
        sd, meta = blob, {}
    params = params_from_state_dict(sd)
    stored = meta.get("model_config")
    cfg = config_from_params(
        params, meta.get("args"),
        stored.get("compute_dtype", "float32") if isinstance(stored, dict)
        else "float32")
    meta_out = {k: v for k, v in meta.items()
                if isinstance(v, (int, float, str, bool))}
    return params_to(params, device), cfg, meta_out


def save_reference_pt(params: Params, cfg: ModelConfig, path,
                      meta: Optional[Dict[str, Any]] = None) -> None:
    """Write params as a reference-layout checkpoint, with ``cfg`` as its
    ``model_config`` dict."""
    args = argparse.Namespace(
        embedding_dim=cfg.embedding_dim, hidden_dim=cfg.hidden_dim,
        dropout=cfg.dropout, decoder_dropout=cfg.decoder_dropout,
        num_bases=cfg.num_bases)
    torch.save({"model_state_dict": state_dict_from_params(params),
                "args": args, "model_config": cfg.to_dict(), **(meta or {})},
               path)


def params_from_jax(tree: Dict[str, Any], *, device="cpu") -> Params:
    """The JAX package's parameter pytree, its leaves converted to numpy
    arrays by the caller, -> this package's parameter dict (same layout)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32, copy=True)).to(device)


def main(argv=None):
    """CLI: convert a reference ``.pt`` into a JAX checkpoint (``import``:
    the parameters with a fresh optimizer state, adam ``count`` 0 and zero
    moments of ``TrainConfig()``'s chain, as the JAX ``import`` writes
    them) or a JAX checkpoint (or a ``.pt``) into a reference ``.pt``
    (``export``: the parameters, ``args``, ``model_config`` and
    ``{"epoch": ...}``)."""
    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.train import checkpoint
    from primekg_rgcn_tpu_torch.train.loop import make_optimizer

    p = argparse.ArgumentParser(description="Torch checkpoint interop")
    p.add_argument("mode", choices=["import", "export"])
    p.add_argument("src")
    p.add_argument("dst")
    args = p.parse_args(argv)

    if args.mode == "import":
        params, cfg, meta = load_reference_pt(args.src)
        train_cfg = TrainConfig()
        opt_state = checkpoint.optimizer_state_to_jax(
            make_optimizer(train_cfg, params), params, train_cfg)
        checkpoint.save_jax(args.dst, {
            "state": {"params": params, "opt_state": opt_state,
                      "step": torch.zeros((), dtype=torch.int32)},
            "epoch": meta.get("epoch", 0),
            "best_val_loss": meta.get("best_val_loss", float("inf")),
            "best_val_acc": meta.get("best_val_acc", 0.0),
            "history": {"train_losses": [], "val_losses": [],
                        "train_accs": [], "val_accs": []},
            "model_config": cfg.to_dict(),
            "train_config": train_cfg.to_dict(),
        })
        print(f"imported {args.src} -> {args.dst} "
              f"({cfg.num_nodes} nodes, {cfg.num_relations} relations)")
    else:
        payload = checkpoint.load(args.src)
        save_reference_pt(payload["params"],
                          ModelConfig.from_dict(payload["model_config"]),
                          args.dst, {"epoch": payload.get("epoch", 0)})
        print(f"exported {args.src} -> {args.dst}")


if __name__ == "__main__":
    main()
