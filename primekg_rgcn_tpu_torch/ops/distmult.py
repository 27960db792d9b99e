"""DistMult scoring.

    score(h, r, t) = sum(h * e_r * t)          (triple scoring)
    score_all(h, r) = (h * e_r) @ E^T          (all-tails ranking matmul)

A plain float32 matrix product: ``torch.matmul`` (cuBLAS on the card, with
TF32 off by PyTorch's default).
"""

from __future__ import annotations

import torch


def distmult_score(head_emb: torch.Tensor, tail_emb: torch.Tensor,
                   rel_emb: torch.Tensor) -> torch.Tensor:
    """Batched triple scores. [B, D] x [B, D] x [B, D] -> [B]."""
    return torch.sum(head_emb * rel_emb * tail_emb, dim=-1)


def distmult_score_all_tails(head_emb: torch.Tensor, rel_emb: torch.Tensor,
                             all_tail_emb: torch.Tensor) -> torch.Tensor:
    """Scores against every entity. [B, D], [B, D], [N, D] -> [B, N]."""
    return (head_emb * rel_emb) @ all_tail_emb.T
