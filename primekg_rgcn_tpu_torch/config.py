"""Model, training, evaluation and preprocessing configuration, shared field
for field with the JAX package's ``ModelConfig``, ``TrainConfig``,
``EvalConfig`` and ``DataConfig`` so that a config dict moves between the
two unchanged (fields of the JAX package that the port does not read are
dropped on the way in)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the RGCN encoder + DistMult decoder.

    Defaults mirror the reference model: 64-dim learnable node embeddings,
    two RGCN layers to 128 dims, dropout 0.5 between them, optional basis
    decomposition. Parameters are always stored in float32;
    ``compute_dtype="bfloat16"`` runs the layers in bf16 as the JAX
    package's accelerator path does (``ops/rgcn_segment.py``).
    """

    num_nodes: int
    num_relations: int
    embedding_dim: int = 64
    hidden_dim: int = 128
    dropout: float = 0.5
    decoder_dropout: float = 0.0
    num_bases: Optional[int] = None
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters of the full-graph trainer.

    Defaults mirror the reference CLI: adam, lr 1e-3, batch 1024, one
    negative per positive, global-norm clip 1.0, no accumulation, a
    periodic checkpoint every 10 epochs, no early stopping.
    """

    epochs: int = 100
    batch_size: int = 1024
    lr: float = 1e-3
    weight_decay: float = 0.0
    optimizer: str = "adam"  # "adam" | "adamw" | "sgd"
    num_neg_samples: int = 1
    grad_clip: float = 1.0
    gradient_accumulation_steps: int = 1
    save_every: int = 10
    early_stopping: int = 0
    seed: int = 42
    # Work per CUDA graph replay: on the full-graph trainer, optimizer
    # updates per captured segment (then one remainder segment); on the
    # one-device sampled trainer (--sample_fanouts), steps per captured
    # chunk. 0 takes each trainer's default (train/graphs.py). The JAX
    # package's 0, the whole epoch in one execution, is a TPU dispatch
    # figure the port does not copy.
    steps_per_scan: int = 0
    # The batch-restricted final layer (ops/rgcn_final_layer.py), the JAX
    # package's tri-state: "auto"/None takes it when the graph's edges are
    # >= AUTO_EDGE_RATIO x the plan's capacity, "on"/True always,
    # "off"/False never. Read by the full-graph trainer only.
    restrict_final: Any = "auto"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation options (the reference's evaluate CLI). The JAX package's
    ``impl`` has no counterpart: the layer follows the tensors' device,
    kernel B1 on the card and its plain version on the CPU."""

    batch_size: int = 1024
    num_neg_samples: int = 1
    k_values: Tuple[int, ...] = (10, 50)
    seed: int = 42

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["k_values"] = list(self.k_values)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EvalConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        if "k_values" in d:
            d["k_values"] = tuple(d["k_values"])
        return cls(**d)


@dataclass(frozen=True)
class DataConfig:
    """Preprocessing options (the reference's preprocess CLI)."""

    raw_data: str = "data/raw/kg.csv"
    processed_dir: str = "data/processed"
    train_ratio: float = 0.7
    val_ratio: float = 0.15
    test_ratio: float = 0.15
    seed: int = 42
    target_relation: str = "drug-gene"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)
