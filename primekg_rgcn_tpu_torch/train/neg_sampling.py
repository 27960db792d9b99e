"""Negative sampling for link prediction, and the BCE statistics.

Each positive triple is repeated ``num_neg_samples`` times (repeat
interleaved: the copies of one positive are adjacent); for each copy a fair
coin decides whether the head or the tail is replaced by a uniformly random
entity. True edges are not rejected, as in the reference. The draws come
from the caller's ``torch.Generator`` on the batch's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def sample_negatives(pos_head: torch.Tensor, pos_tail: torch.Tensor,
                     pos_rel: torch.Tensor, num_nodes: int,
                     num_neg_samples: int = 1, *,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Corrupt positives into negatives: (neg_head, neg_tail, neg_rel), each
    ``len(pos_head) * num_neg_samples`` long."""
    neg_head = pos_head.repeat_interleave(num_neg_samples)
    neg_tail = pos_tail.repeat_interleave(num_neg_samples)
    neg_rel = pos_rel.repeat_interleave(num_neg_samples)
    total, dev = neg_head.shape[0], neg_head.device
    corrupt_head = torch.rand(total, generator=generator, device=dev) < 0.5
    random_entities = torch.randint(0, num_nodes, (total,),
                                    generator=generator, device=dev,
                                    dtype=neg_head.dtype)
    neg_head = torch.where(corrupt_head, random_entities, neg_head)
    neg_tail = torch.where(corrupt_head, neg_tail, random_entities)
    return neg_head, neg_tail, neg_rel


def candidate_batch(pos_head: torch.Tensor, pos_tail: torch.Tensor,
                    pos_rel: torch.Tensor, num_nodes: int,
                    num_neg_samples: int = 1,
                    mask: Optional[torch.Tensor] = None, *,
                    generator: Optional[torch.Generator] = None):
    """Positives followed by their corrupted negatives as one scoring batch:
    (heads, tails, rels, labels, weights). ``weights`` are ones unless a
    padding ``mask`` over the positives is given; it repeats onto each
    positive's negatives."""
    neg_head, neg_tail, neg_rel = sample_negatives(
        pos_head, pos_tail, pos_rel, num_nodes, num_neg_samples,
        generator=generator)
    heads = torch.cat([pos_head, neg_head])
    tails = torch.cat([pos_tail, neg_tail])
    rels = torch.cat([pos_rel, neg_rel])
    labels = torch.cat([
        torch.ones(pos_head.shape[0], device=pos_head.device),
        torch.zeros(neg_head.shape[0], device=pos_head.device)])
    if mask is None:
        weights = torch.ones_like(labels)
    else:
        m = mask.float()
        weights = torch.cat([m, m.repeat_interleave(num_neg_samples)])
    return heads, tails, rels, labels, weights


def bce_stats(scores: torch.Tensor, labels: torch.Tensor,
              weights: torch.Tensor):
    """Weighted BCE-with-logits statistics: (loss_sum, correct, count), all
    0-d tensors on the scores' device; the mean loss is
    ``loss_sum / max(count, 1)``. The per-example loss is the stable form
    ``-y log sigmoid(s) - (1 - y) log sigmoid(-s)``, as
    ``optax.sigmoid_binary_cross_entropy`` computes it."""
    per_ex = (-labels * F.logsigmoid(scores)
              - (1.0 - labels) * F.logsigmoid(-scores))
    preds = (torch.sigmoid(scores) > 0.5).float()
    correct = ((preds == labels).float() * weights).sum()
    return (per_ex * weights).sum(), correct, weights.sum()
