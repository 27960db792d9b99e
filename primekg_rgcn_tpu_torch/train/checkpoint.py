"""Checkpoints of the port: reference-layout ``.pt`` files only.

The trainer writes the reference's layout (``model_state_dict`` as PyG's
RGCNConv keeps it, ``optimizer_state_dict``, ``epoch``, ``best_val_loss``,
``best_val_acc``, ``history``, ``args`` as an ``argparse.Namespace``) plus
``model_config`` and ``train_config`` as plain dicts and the random
generators' states as tensors. The pickle holds nothing of this package,
so the JAX package's ``checkpoint.load`` reads the file as it stands.

The JAX package's own format (``path.msgpack`` + ``path.json``) needs flax
to read. Convert such a checkpoint once with
``python -m primekg_rgcn_tpu.train.torch_interop export ckpt out.pt``.
"""

from __future__ import annotations

import copy
import os
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from primekg_rgcn_tpu_torch.train.torch_interop import reference_from_blob

# Entries of a trainer checkpoint that ``load`` passes through when present.
TRAINER_KEYS = ("history", "optimizer_state_dict", "train_config",
                "rng_state", "device_rng_state")


def is_torch_checkpoint(path: Path) -> bool:
    """True for a torch pickle (by suffix, or by zip / legacy pickle magic)."""
    if path.suffix in (".pt", ".pth"):
        return path.is_file()
    if not path.is_file():
        return False
    with open(path, "rb") as f:
        magic = f.read(2)
    return magic in (b"PK", b"\x80\x02")


def save(path, payload: Dict[str, Any]) -> None:
    """Write ``payload`` with ``torch.save``, atomically: to a temporary
    file beside ``path``, then ``os.replace``, so that a run killed while
    saving leaves the previous file whole."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _host_snapshot(obj):
    """A copy of ``obj`` that later training cannot change: every tensor
    copied to the host now (a CUDA tensor's copy waits for the device), and
    every container and other value copied."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _host_snapshot(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_snapshot(v) for v in obj)
    return copy.deepcopy(obj)


class AsyncSaver:
    """Non-blocking :func:`save` on one background thread.

    ``save_async`` copies the payload to the host at once, so the file holds
    the state of the moment of the call, and leaves ``torch.save`` and the
    disk write to the thread: the training loop goes on meanwhile. Writes
    run in call order; a save to a path that is still being written waits
    for that write first. ``wait_for_saves`` drains them all and raises the
    first writer error.
    """

    def __init__(self):
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: Dict[Path, Future] = {}

    def save_async(self, path, payload: Dict[str, Any]) -> Future:
        path = Path(path)
        earlier = self._pending.pop(path, None)
        if earlier is not None:
            earlier.result()
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="ckpt-save")
        fut = self._pool.submit(save, path, _host_snapshot(payload))
        self._pending[path] = fut
        return fut

    def wait_for_saves(self) -> None:
        """Block until every pending write is on disk; stop the thread."""
        pending, self._pending = self._pending, {}
        pool, self._pool = self._pool, None
        try:
            for fut in pending.values():
                fut.result()
        finally:
            if pool is not None:
                pool.shutdown(wait=True)


def load(path, *, device="cpu") -> Dict[str, Any]:
    """Read a reference-layout ``.pt`` checkpoint.

    Returns {"params", "model_config" (dict), "epoch", "best_val_loss",
    "best_val_acc"} with the parameters on ``device``, and the entries of
    ``TRAINER_KEYS`` that the file holds (on the CPU). ``model_config``
    comes from the parameter shapes, with the ``compute_dtype`` of the
    file's own ``model_config`` when it has one (else float32), so a model
    trained in bf16 serves and evaluates in bf16. The file is a pickle:
    load only trusted checkpoints.
    """
    path = Path(path)
    if not is_torch_checkpoint(path):
        raise ValueError(
            f"{path} is not a reference-layout .pt checkpoint. A checkpoint "
            "of the JAX package (path.msgpack + path.json) converts with: "
            "python -m primekg_rgcn_tpu.train.torch_interop export "
            f"{path} out.pt")
    blob = torch.load(path, map_location="cpu", weights_only=False)
    params, cfg, meta = reference_from_blob(blob, device=device)
    out = {
        "params": params,
        "model_config": cfg.to_dict(),
        "epoch": meta.get("epoch", 0),
        "best_val_loss": meta.get("best_val_loss", float("inf")),
        "best_val_acc": meta.get("best_val_acc", 0.0),
    }
    if isinstance(blob, dict):
        out.update({k: blob[k] for k in TRAINER_KEYS if k in blob})
    return out
