"""Checkpoint loading for the port: reference-layout ``.pt`` files only.

The JAX package's own format (``path.msgpack`` + ``path.json``) needs flax
to read. Convert such a checkpoint once with
``python -m primekg_rgcn_tpu.train.torch_interop export ckpt out.pt``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

from primekg_rgcn_tpu_torch.train.torch_interop import load_reference_pt


def is_torch_checkpoint(path: Path) -> bool:
    """True for a torch pickle (by suffix, or by zip / legacy pickle magic)."""
    if path.suffix in (".pt", ".pth"):
        return path.is_file()
    if not path.is_file():
        return False
    with open(path, "rb") as f:
        magic = f.read(2)
    return magic in (b"PK", b"\x80\x02")


def load(path, *, device="cpu") -> Dict[str, Any]:
    """Read a reference-layout ``.pt`` checkpoint.

    Returns {"params", "model_config" (dict), "epoch", "best_val_loss",
    "best_val_acc"} with the parameters on ``device``.
    """
    path = Path(path)
    if not is_torch_checkpoint(path):
        raise ValueError(
            f"{path} is not a reference-layout .pt checkpoint. A checkpoint "
            "of the JAX package (path.msgpack + path.json) converts with: "
            "python -m primekg_rgcn_tpu.train.torch_interop export "
            f"{path} out.pt")
    params, cfg, meta = load_reference_pt(path, device=device)
    return {
        "params": params,
        "model_config": cfg.to_dict(),
        "epoch": meta.get("epoch", 0),
        "best_val_loss": meta.get("best_val_loss", float("inf")),
        "best_val_acc": meta.get("best_val_acc", 0.0),
    }
