"""RGCN encoder + DistMult decoder, as a parameter dict and apply functions.

The parameter dict has the JAX package's layout, so parameters move between
the two packages leaf by leaf (``train/torch_interop.params_from_jax``):

    {"encoder": {"node_emb": [N, d_emb],
                 "conv1": {"w_rel" | "basis"+"coef", "w_root", "bias"},
                 "conv2": {...}},
     "decoder": {"rel_emb": [R, d_h]}}

Architecture: node embedding table -> RGCN layer (d_emb -> d_h) -> ReLU ->
Dropout (training only) -> RGCN layer (d_h -> d_h); DistMult decoder, with
optional dropout on the relation embeddings in training. The default config
has 2,078,208 parameters, as the reference model. ``encoder_apply_sampled``
runs the same encoder over a sampled neighbourhood (``data/sampling``);
``encoder_apply_cached`` runs it over one sampled hop and a table of
layer-1 histories.

``cfg.compute_dtype`` ("float32" or "bfloat16") reaches every layer; the
parameters, the decoder and the loss stay float32, and each encoder returns
float32 rows.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from primekg_rgcn_tpu_torch.config import ModelConfig
from primekg_rgcn_tpu_torch.data.graph import RelGraph
from primekg_rgcn_tpu_torch.data.sampling import (CombinedBlock,
                                                  SampledBatch,
                                                  TableGatherSorted,
                                                  block_aggregate)
from primekg_rgcn_tpu_torch.ops.distmult import (distmult_score,
                                                 distmult_score_all_tails)
from primekg_rgcn_tpu_torch.ops.rgcn_final_layer import (
    BatchRanges, FinalLayerPlan, final_layer_restricted)
from primekg_rgcn_tpu_torch.ops.rgcn_segment import rgcn_layer_segment

Params = Dict[str, Any]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype of ``cfg.compute_dtype``."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _xavier_uniform(gen: torch.Generator, shape, fan_in: int,
                    fan_out: int) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen, dtype=torch.float32)
            * (2 * limit) - limit)


def _init_conv(gen: torch.Generator, din: int, dout: int, num_relations: int,
               num_bases: Optional[int]) -> Params:
    conv: Params = {}
    if num_bases is None:
        conv["w_rel"] = _xavier_uniform(gen, (num_relations, din, dout), din, dout)
    else:
        conv["basis"] = _xavier_uniform(gen, (num_bases, din, dout), din, dout)
        conv["coef"] = _xavier_uniform(gen, (num_relations, num_bases),
                                       num_relations, num_bases)
    conv["w_root"] = _xavier_uniform(gen, (din, dout), din, dout)
    conv["bias"] = torch.zeros(dout, dtype=torch.float32)
    return conv


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                device="cpu") -> Params:
    """Xavier-uniform parameters drawn from ``gen`` (a CPU generator, so a
    seed gives the same weights on any device), placed on ``device``."""
    params = {
        "encoder": {
            "node_emb": _xavier_uniform(
                gen, (cfg.num_nodes, cfg.embedding_dim),
                cfg.num_nodes, cfg.embedding_dim),
            "conv1": _init_conv(gen, cfg.embedding_dim, cfg.hidden_dim,
                                cfg.num_relations, cfg.num_bases),
            "conv2": _init_conv(gen, cfg.hidden_dim, cfg.hidden_dim,
                                cfg.num_relations, cfg.num_bases),
        },
        "decoder": {
            "rel_emb": _xavier_uniform(
                gen, (cfg.num_relations, cfg.hidden_dim),
                cfg.num_relations, cfg.hidden_dim),
        },
    }
    return params_to(params, device)


def params_to(params: Params, device) -> Params:
    """The same nested dict with every tensor on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


def param_leaves(params: Params):
    """The parameter tensors of the nested dict, in insertion order."""
    if isinstance(params, dict):
        for v in params.values():
            yield from param_leaves(v)
    else:
        yield params


def count_params(params: Params) -> int:
    return sum(int(p.numel()) for p in param_leaves(params))


def dropout(x: torch.Tensor, rate: float, *,
            generator: Optional[torch.Generator] = None,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability ``1 - rate`` and
    scale it by ``1/keep`` in x's dtype (a Python scalar keeps a bf16
    tensor bf16, as a weak-typed ``jnp`` scalar does). The keep ``mask``
    (bool, x's shape) is drawn from ``generator`` on x's device unless the
    caller passes it."""
    keep = 1.0 - rate
    if mask is None:
        if generator is None:
            raise ValueError("dropout needs a generator or a mask")
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), device=x.device))


def encoder_apply(params: Params, graph: RelGraph, cfg: ModelConfig, *,
                  train: bool = False,
                  generator: Optional[torch.Generator] = None,
                  mask: Optional[torch.Tensor] = None,
                  layer_fn=rgcn_layer_segment) -> torch.Tensor:
    """Full-graph encode: [N, hidden_dim] node embeddings (embed -> conv1
    -> ReLU -> dropout -> conv2), each layer in ``cfg.compute_dtype``.
    Dropout applies only with ``train``; its keep mask comes from
    ``generator`` or is given as ``mask``."""
    enc = params["encoder"]
    cdt = compute_dtype(cfg)
    x = layer_fn(enc["conv1"], enc["node_emb"], graph, compute_dtype=cdt)
    x = torch.relu(x)
    if train and cfg.dropout > 0.0:
        x = dropout(x, cfg.dropout, generator=generator, mask=mask)
    return layer_fn(enc["conv2"], x, graph, compute_dtype=cdt)


def model_apply(params: Params, graph: RelGraph, heads, tails, rels,
                cfg: ModelConfig, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                enc_mask: Optional[torch.Tensor] = None,
                dec_mask: Optional[torch.Tensor] = None,
                layer_fn=rgcn_layer_segment,
                final_plan: Optional[FinalLayerPlan] = None,
                final_ranges: Optional[BatchRanges] = None) -> torch.Tensor:
    """Training forward: encode the whole graph, score a triple batch [B].

    The encoder runs over the entire message-passing graph for every batch
    and gradients flow through it. With ``train``, encoder dropout and
    decoder dropout (on the gathered relation embeddings) apply, with masks
    drawn from ``generator`` (encoder first) or given as
    ``enc_mask``/``dec_mask``.

    ``final_plan`` (``ops/rgcn_final_layer.plan_final_layer``) computes the
    final conv at the heads' and tails' rows only, with the same values and
    gradients; layer 1 (through ``layer_fn``) and its dropout run as in
    :func:`encoder_apply`. ``final_ranges`` hands it the batch's ranges
    with their overflow flag already read (``final_layer_restricted``'s
    ``ranges``).
    """
    if final_plan is not None:
        enc = params["encoder"]
        cdt = compute_dtype(cfg)
        x = torch.relu(layer_fn(enc["conv1"], enc["node_emb"], graph,
                                compute_dtype=cdt))
        if train and cfg.dropout > 0.0:
            x = dropout(x, cfg.dropout, generator=generator, mask=enc_mask)
        x_pad = torch.cat([x, x.new_zeros(1, x.shape[1])], dim=0)
        out = final_layer_restricted(enc["conv2"], x_pad, graph, final_plan,
                                     torch.cat([heads, tails]),
                                     compute_dtype=cdt, ranges=final_ranges)
        head_emb, tail_emb = out[: heads.shape[0]], out[heads.shape[0]:]
    else:
        node_emb = encoder_apply(params, graph, cfg, train=train,
                                 generator=generator, mask=enc_mask,
                                 layer_fn=layer_fn)
        head_emb, tail_emb = node_emb[heads], node_emb[tails]
    rel_emb = params["decoder"]["rel_emb"][rels]
    if train and cfg.decoder_dropout > 0.0:
        rel_emb = dropout(rel_emb, cfg.decoder_dropout, generator=generator,
                          mask=dec_mask)
    return distmult_score(head_emb, tail_emb, rel_emb)


def predict(params: Params, graph: RelGraph, heads, tails, rels,
            cfg: ModelConfig, *, layer_fn=rgcn_layer_segment) -> torch.Tensor:
    """Inference triple scoring [B] (no dropout)."""
    return model_apply(params, graph, heads, tails, rels, cfg,
                       layer_fn=layer_fn)


def predict_all_tails(params: Params, graph: RelGraph, heads, rels,
                      cfg: ModelConfig, *,
                      layer_fn=rgcn_layer_segment) -> torch.Tensor:
    """[B, N] scores of every entity as tail."""
    node_emb = encoder_apply(params, graph, cfg, layer_fn=layer_fn)
    rel_emb = params["decoder"]["rel_emb"][rels]
    return distmult_score_all_tails(node_emb[heads], rel_emb, node_emb)


def get_embeddings(params: Params, graph: RelGraph, cfg: ModelConfig, *,
                   layer_fn=rgcn_layer_segment) -> torch.Tensor:
    """Encoder output at inference."""
    return encoder_apply(params, graph, cfg, layer_fn=layer_fn)


def _frontier_rows(table: torch.Tensor, frontier: torch.Tensor,
                   cdt: torch.dtype, x0: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """The layer-0 input of a dedup block: ``x0`` in ``cdt`` when given,
    else the frontier's table rows gathered (sorted backward), then
    converted, the sentinel rows zero."""
    if x0 is not None:
        return x0.to(cdt)
    n = table.shape[0]
    x = TableGatherSorted.apply(table, frontier.clamp(max=n - 1)).to(cdt)
    return torch.where((frontier == n)[:, None],
                       torch.zeros((), device=x.device), x)


def encoder_apply_sampled(params: Params, batch: SampledBatch,
                          cfg: ModelConfig, *, train: bool = False,
                          generator: Optional[torch.Generator] = None,
                          mask: Optional[torch.Tensor] = None,
                          x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encode only a sampled neighbourhood block (mini-batch mode):
    [num_seeds, hidden_dim] embeddings in seed order.

    Per-relation mean over the sampled neighbours, the same root, bias,
    ReLU and dropout structure as :func:`encoder_apply`. The layer-0 table
    is the embedding table itself for an identity innermost block, else the
    deduped frontier's rows (sentinel rows zero), gathered with a sorted
    backward. ``x0`` supplies those layer-0 rows directly (the sparse
    embedding update's hook). Sentinel output rows are zeroed after every
    layer, so the bias never leaks upward. Dropout applies only with
    ``train``; its keep mask comes from ``generator`` or is given as
    ``mask``.

    Under bf16 compute the layer-0 rows are gathered in float32 and then
    converted (never the whole table): by the identity block's pick gather
    itself, else after the frontier gather. The output is float32.
    """
    enc = params["encoder"]
    n = cfg.num_nodes
    cdt = compute_dtype(cfg)
    ident0 = bool(getattr(batch.blocks[0], "ident", False))
    if ident0:
        x = x0 if x0 is not None else enc["node_emb"]
    else:
        x = _frontier_rows(enc["node_emb"], batch.frontier, cdt, x0)

    layers = [enc["conv1"], enc["conv2"]]
    if len(batch.blocks) != len(layers):
        raise ValueError(
            f"need {len(layers)} sampled blocks, got {len(batch.blocks)}")
    for li, (layer, block) in enumerate(zip(layers, batch.blocks)):
        x = block_aggregate(layer, x, block,
                            compute_dtype=cdt if li == 0 and ident0 else None)
        x = torch.where((block.out_ids == n)[:, None],
                        torch.zeros((), device=x.device), x)
        if li < len(layers) - 1:
            x = torch.relu(x)
            if train and cfg.dropout > 0.0:
                x = dropout(x, cfg.dropout, generator=generator, mask=mask)
    return x[batch.seed_gather.long()].float()


def encoder_apply_cached(params: Params, batch: SampledBatch,
                         cache: torch.Tensor, cfg: ModelConfig, *,
                         train: bool = False,
                         generator: Optional[torch.Generator] = None,
                         mask: Optional[torch.Tensor] = None,
                         x0: Optional[torch.Tensor] = None):
    """The historical-embedding encode (GAS / VR-GCN style): one sampled hop
    serves both convolutions, conv2 reading layer-1 rows from ``cache``
    [N, hidden_dim], the histories (``encoder_apply_cached`` in the JAX
    package).

    - conv1 runs fresh at the hop's output rows (the deduplicated seeds)
      over their sampled neighbours' table rows, pre-activation and without
      dropout, so gradients reach the table and conv1 as in the two-hop
      encode;
    - the fresh rows are pushed into ``cache`` under no grad (histories are
      constants), the sentinel id N dropped;
    - conv2's input table is the updated cache's rows at the hop's frontier,
      the output rows' own positions (``block.self_idx``) overwritten by
      the fresh rows out of place, so gradients reach conv1 only through
      them; then ReLU, dropout (``generator`` or the keep ``mask`` over that
      [M_in, hidden_dim] table) and conv2.

    ``batch`` holds one dedup ``CombinedBlock`` (an identity block has no
    frontier to address the cache with: ``ValueError``). ``x0`` supplies
    the frontier's layer-0 rows, as in :func:`encoder_apply_sampled`. The
    cache is in the compute dtype and is written in place. Returns
    ``(emb, cache)``: float32 [num_seeds, hidden_dim] embeddings in seed
    order, and the updated cache.
    """
    enc = params["encoder"]
    n = cfg.num_nodes
    cdt = compute_dtype(cfg)
    if len(batch.blocks) != 1:
        raise ValueError(f"cached encoder needs exactly 1 sampled hop, got "
                         f"{len(batch.blocks)}")
    block = batch.blocks[0]
    if not isinstance(block, CombinedBlock) or block.ident:
        raise ValueError(
            "cached encoder needs a dedup-frontier CombinedBlock (the "
            "frontier's global ids address the history table)")
    x = _frontier_rows(enc["node_emb"], batch.frontier, cdt, x0)
    out_sentinel = (block.out_ids == n)[:, None]
    zero = torch.zeros((), device=x.device)
    h1 = torch.where(out_sentinel, zero, block_aggregate(enc["conv1"], x,
                                                         block))
    with torch.no_grad():
        # The push, without a host sync: the sentinel rows (the fill at the
        # end of the sorted-unique out_ids) write row t's own new value,
        # where t is the first output row's id, so every write to a row
        # carries one value.
        ids = block.out_ids.long()
        t = ids[:1].clamp(max=n - 1)
        v_t = torch.where(ids[:1, None] < n, h1[:1].to(cache.dtype),
                          cache[t])
        cache.index_put_((torch.where(ids < n, ids, t),),
                         torch.where(out_sentinel, v_t, h1.to(cache.dtype)))
        hist = cache[batch.frontier.clamp(max=n - 1).long()]
        hist = torch.where((batch.frontier == n)[:, None],
                           torch.zeros((), device=hist.device), hist)
    h_tab = torch.index_put(hist.to(h1.dtype), (block.self_idx.long(),), h1)
    a = torch.relu(h_tab)
    if train and cfg.dropout > 0.0:
        a = dropout(a, cfg.dropout, generator=generator, mask=mask)
    out = torch.where(out_sentinel, zero, block_aggregate(enc["conv2"], a,
                                                          block))
    return out[batch.seed_gather.long()].float(), cache
