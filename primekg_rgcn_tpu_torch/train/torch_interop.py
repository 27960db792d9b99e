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
The JAX package writes the same layout, so a model trained there serves
here after ``python -m primekg_rgcn_tpu.train.torch_interop export ckpt
out.pt``.

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
