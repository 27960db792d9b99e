"""Model configuration, shared field for field with the JAX package's
``ModelConfig`` so that a config dict moves between the two unchanged."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the RGCN encoder + DistMult decoder.

    Defaults mirror the reference model: 64-dim learnable node embeddings,
    two RGCN layers to 128 dims, dropout 0.5 between them, optional basis
    decomposition. Parameters are always stored in float32.
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
        if self.compute_dtype == "bfloat16":
            raise NotImplementedError(
                "compute_dtype='bfloat16' is not ported yet; use float32")
        if self.compute_dtype != "float32":
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
