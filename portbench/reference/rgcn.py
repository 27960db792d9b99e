"""Plain full-graph RGCN + DistMult training updates, in PyTorch.

The reference that a full-graph cell's first updates are held against. It
imports nothing of the program and takes none of its arrays: it builds its
own per-relation edge lists and in-degrees from the benchmark's directed
train edges, starts from the benchmark's initial weights and draws the
batch order, the negatives and the dropout masks from generators seeded as
the benchmark seeded the program's, in the order the model defines them.

One update, as the RGCN (Schlichtkrull et al., arXiv:1703.06103) with a
DistMult decoder (Yang et al., arXiv:1412.6575) trains:

- the batch's positives, each with one corruption: a fair coin (uniform <
  0.5) replaces the head, else the tail, by a uniform entity;
- conv1 over every node: ``x W_root + b + sum_r mean_{in-edges of r}(x)
  W_r``, where the mean divides by the in-degree under r (multiple edges
  counted); ReLU; dropout, keep 1 - p, kept entries scaled by 1 / keep;
- conv2 likewise on its output;
- DistMult ``sum(h * r * t)``, dropout on the gathered relation rows;
- the mean binary cross-entropy with logits;
- the gradient clipped to global norm ``grad_clip`` (no epsilon), then
  Adam (betas 0.9, 0.999, eps 1e-8, bias-corrected).

``precision`` "float32" runs every matmul in float32 with TF32 off;
"tf32" is the control: TF32 matmuls on the card, emulated on the CPU by
rounding each operand to TF32's 10-bit mantissa. ``fault`` plants a fault
for the readings of a fault: "half" scores only the first half of the
batch (the mean over the rest), "answer" alters the first score.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

LEAVES = ("encoder.node_emb", "encoder.conv1.w_rel", "encoder.conv1.w_root",
          "encoder.conv1.bias", "encoder.conv2.w_rel", "encoder.conv2.w_root",
          "encoder.conv2.bias", "decoder.rel_emb")


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (a 10-bit mantissa), kept in float32."""
    bits = x.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """``a @ b`` with every operand rounded to TF32, forward and backward,
    summed in float32: what TF32 matmuls do, on the CPU."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tf32_round(a) @ _tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32_round(g)
        return g @ _tf32_round(b).T, _tf32_round(a).T @ g


@contextlib.contextmanager
def _precision(precision: str, device: torch.device):
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = (precision == "tf32"
                                             and device.type == "cuda")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class Graph:
    """Per-relation (src, dst) index tensors and reciprocal in-degrees of
    directed [E, 3] (head, tail, relation) edges."""

    def __init__(self, edges: np.ndarray, num_nodes: int, num_relations: int,
                 device: torch.device):
        self.num_nodes = num_nodes
        self.rel: List[Optional[tuple]] = []
        for r in range(num_relations):
            sel = edges[edges[:, 2] == r]
            if sel.shape[0] == 0:
                self.rel.append(None)
                continue
            src = torch.from_numpy(np.ascontiguousarray(sel[:, 0])).to(device)
            dst = torch.from_numpy(np.ascontiguousarray(sel[:, 1])).to(device)
            deg = torch.bincount(dst, minlength=num_nodes).float()
            inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                              torch.zeros((), device=device))
            self.rel.append((src, dst, inv[:, None]))


class Model:
    """The forward pass at one precision."""

    def __init__(self, graph: Graph, dropout: float, decoder_dropout: float,
                 precision: str, emulate_tf32: bool):
        self.graph, self.p, self.p_dec = graph, dropout, decoder_dropout
        self.emulate = precision == "tf32" and emulate_tf32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _TF32Matmul.apply(a, b) if self.emulate else a @ b

    def conv(self, x, w_rel, w_root, bias):
        out = self.mm(x, w_root) + bias[None, :]
        for r, entry in enumerate(self.graph.rel):
            if entry is None:
                continue
            src, dst, inv = entry
            agg = x.new_zeros(x.shape).index_add_(0, dst, x[src])
            out = out + self.mm(agg * inv, w_rel[r])
        return out

    @staticmethod
    def dropout(x, rate, gen):
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), device=x.device))

    def scores(self, p: Dict[str, torch.Tensor], heads, tails, rels, gen):
        x = torch.relu(self.conv(p["encoder.node_emb"], p["encoder.conv1.w_rel"],
                                 p["encoder.conv1.w_root"],
                                 p["encoder.conv1.bias"]))
        if self.p > 0:
            x = self.dropout(x, self.p, gen)
        emb = self.conv(x, p["encoder.conv2.w_rel"], p["encoder.conv2.w_root"],
                        p["encoder.conv2.bias"])
        rel = p["decoder.rel_emb"][rels]
        if self.p_dec > 0:
            rel = self.dropout(rel, self.p_dec, gen)
        return (emb[heads] * rel * emb[tails]).sum(-1)


def candidates(batch: torch.Tensor, num_nodes: int, k: int,
               gen: torch.Generator):
    """(heads, tails, rels, labels): the positives, then their corruptions."""
    h, t, r = batch[:, 0], batch[:, 1], batch[:, 2]
    nh, nt, nr = (v.repeat_interleave(k) for v in (h, t, r))
    n = nh.shape[0]
    coin = torch.rand(n, generator=gen, device=batch.device) < 0.5
    ent = torch.randint(0, num_nodes, (n,), generator=gen,
                        device=batch.device, dtype=nh.dtype)
    nh, nt = torch.where(coin, ent, nh), torch.where(coin, nt, ent)
    labels = torch.cat([torch.ones(h.shape[0], device=batch.device),
                        torch.zeros(n, device=batch.device)])
    return (torch.cat([h, nh]), torch.cat([t, nt]), torch.cat([r, nr]),
            labels)


def train_steps(edges: np.ndarray, num_nodes: int, num_relations: int,
                epoch_edges: np.ndarray, params0: Dict[str, torch.Tensor], *,
                model: Dict, train: Dict, batch_size: int, perm_seed: int,
                device_seed: int, device, steps: int = 3,
                precision: str = "float32",
                fault: Optional[str] = None) -> Dict:
    """The first ``steps`` updates of an epoch over ``epoch_edges``
    ([M, 3]; its order is ``torch.randperm`` from a CPU generator seeded
    ``perm_seed``) on the message graph ``edges`` ([E, 3]). Returns each
    step's loss, the first step's clipped gradient norm by leaf and each
    leaf's change in norm after the last step."""
    device = torch.device(device)
    graph = Graph(edges, num_nodes, num_relations, device)
    net = Model(graph, model["dropout"], model["decoder_dropout"], precision,
                emulate_tf32=device.type != "cuda")
    lr, clip = train["lr"], train["grad_clip"]
    k = train["num_neg_samples"]
    b1, b2, eps = 0.9, 0.999, 1e-8
    p = {n: params0[n].to(device).clone().requires_grad_(True)
         for n in LEAVES}
    m = {n: torch.zeros_like(v) for n, v in p.items()}
    v2 = {n: torch.zeros_like(v) for n, v in p.items()}
    perm = torch.randperm(epoch_edges.shape[0],
                          generator=torch.Generator().manual_seed(perm_seed))
    gen = torch.Generator(device).manual_seed(device_seed)
    losses, grad1 = [], {}
    with _precision(precision, device):
        for step in range(1, steps + 1):
            rows = perm[(step - 1) * batch_size: step * batch_size].numpy()
            batch = torch.from_numpy(epoch_edges[rows]).to(device)
            heads, tails, rels, labels = candidates(batch, num_nodes, k, gen)
            s = net.scores(p, heads, tails, rels, gen)
            weights = torch.ones_like(labels)
            if fault == "half":
                pos = torch.arange(labels.shape[0], device=device) % \
                    batch.shape[0]
                weights = (pos < batch.shape[0] // 2).float()
            elif fault == "answer":
                s = s + (torch.arange(s.shape[0], device=device) == 0)
            per = F.binary_cross_entropy_with_logits(s, labels,
                                                     reduction="none")
            loss = (per * weights).sum() / weights.sum()
            grads = torch.autograd.grad(loss, [p[n] for n in LEAVES])
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            factor = clip / norm if clip > 0 and norm > clip else 1.0
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for n, g in zip(LEAVES, grads):
                    g = g * factor
                    if step == 1:
                        grad1[n] = float(torch.linalg.vector_norm(g))
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v2[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    m_hat = m[n] / (1 - b1 ** step)
                    v_hat = v2[n] / (1 - b2 ** step)
                    p[n].sub_(lr * m_hat / (v_hat.sqrt() + eps))
    change = {n: float(torch.linalg.vector_norm(
        p[n].detach() - params0[n].to(device))) for n in LEAVES}
    return {"loss": losses, "grad1": grad1, "change": change}
