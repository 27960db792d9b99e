"""Ahead-of-time export of a top-K scorer for serving (``torch.export``).

The counterpart of ``primekg_rgcn_tpu/evaluate/export.py``, whose artifact
is a StableHLO program. The encoder is deterministic at inference, so
serving needs neither the graph nor the RGCN layers: the caller encodes
once (kernel B1 on the card) and this module freezes the [N, D] embeddings
and the relation table into a ``torch.export`` program that scores every
entity as tail and keeps the K best. ``load_predictor`` returns a plain
callable; loading needs torch alone, no code of this package:

    torch.export.load(path).module()(heads, rels)

The matmul runs in float32 under PyTorch's default of TF32 off, as the
evaluator's.
"""

from __future__ import annotations

from pathlib import Path

import torch


class _TopKScorer(torch.nn.Module):
    def __init__(self, node_emb: torch.Tensor, rel_emb: torch.Tensor,
                 topk: int):
        super().__init__()
        self.register_buffer("node_emb", node_emb)
        self.register_buffer("rel_emb", rel_emb)
        self.topk = topk

    def forward(self, heads: torch.Tensor, rels: torch.Tensor):
        q = self.node_emb[heads] * self.rel_emb[rels]
        scores, tails = torch.topk(q @ self.node_emb.T, self.topk, dim=1)
        return scores, tails


def export_topk_predictor(node_emb: torch.Tensor, rel_emb: torch.Tensor,
                          path, *, batch_size: int = 32,
                          topk: int = 10) -> Path:
    """Freeze ``node_emb`` [N, D] and ``rel_emb`` [R, D] (on their device)
    into an exported program mapping ``(heads int64[batch_size], rels
    int64[batch_size])`` to ``(scores f32[batch_size, topk], tails
    int64[batch_size, topk])`` and save it at ``path``. The shapes are
    static: pad a short query batch with any valid id and ignore its rows.
    """
    node_emb = node_emb.detach().float().contiguous()
    rel_emb = rel_emb.detach().float().contiguous()
    # Two distinct example tensors: one passed twice would be traced as
    # one aliased input.
    heads, rels = (torch.zeros(batch_size, dtype=torch.long,
                               device=node_emb.device) for _ in range(2))
    program = torch.export.export(_TopKScorer(node_emb, rel_emb, topk),
                                  (heads, rels))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, path)
    return path


def load_predictor(path):
    """The exported scorer at ``path`` as a plain callable ``(heads, rels)
    -> (scores, tails)`` on int64 tensors on the device it was exported
    on. The file is a pickle-free archive, but load only trusted ones."""
    return torch.export.load(Path(path)).module()
