"""t-SNE, k-means and the silhouette score in torch, in place of sklearn.

The JAX analysis suite calls sklearn's ``TSNE``, ``KMeans`` and
``silhouette_score``; the card's machine has no sklearn. These three run on
a given device ("cuda" for the card), in float32 with float64 where sums are
long, and follow sklearn's definitions:

- ``tsne``: exact-gradient t-SNE with sklearn's defaults (perplexity by a
  binary search per row, early exaggeration 12 for 250 iterations, 1,000
  iterations in all, learning rate ``max(N / 12 / 4, 50)``, momentum 0.5
  then 0.8, per-coordinate gains, PCA init scaled to std 1e-4, the same
  stopping checks every 50 iterations).
- ``kmeans``: k-means++ init with ``2 + ln k`` greedy local trials, then
  Lloyd's iterations to sklearn's tolerance (1e-4 of the mean feature
  variance); the best inertia of ``n_init`` runs.
- ``silhouette``: the exact mean silhouette over Euclidean distances
  computed in float64, ``chunk`` rows at a time.

Their random draws are not sklearn's, so t-SNE and k-means are not equal
to sklearn's, only as good.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

_EPS = float(np.finfo(np.float64).eps)   # sklearn's MACHINE_EPSILON
_EXAGGERATION = 12.0
_EXPLORATION_ITERS = 250
_MAX_ITERS = 1000
_CHECK_EVERY = 50


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[len(a), len(b)] squared Euclidean distances, clamped at 0."""
    d = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)
    return d.clamp_(min=0.0)


def _joint_probabilities(x: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Symmetric P [N, N] (zero diagonal): each row's Gaussian conditional
    at the perplexity found by sklearn's binary search (100 steps, entropy
    tolerance 1e-5), symmetrised and normalised, floored at machine eps."""
    n = x.shape[0]
    dist = _sq_dists(x, x).double()
    dist.fill_diagonal_(0.0)
    off = ~torch.eye(n, dtype=torch.bool, device=x.device)
    target = math.log(perplexity)
    beta = torch.ones(n, 1, dtype=torch.float64, device=x.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    done = torch.zeros_like(beta, dtype=torch.bool)
    for _ in range(100):
        p = torch.exp(-dist * beta) * off
        s = p.sum(1, keepdim=True)
        s = torch.where(s == 0.0, torch.full_like(s, 1e-8), s)
        p = p / s
        entropy = torch.log(s) + beta * (dist * p).sum(1, keepdim=True)
        diff = entropy - target
        done = done | (diff.abs() <= 1e-5)
        if bool(done.all()):
            break
        up = (diff > 0) & ~done
        down = (diff <= 0) & ~done
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = torch.where(
            up, torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            torch.where(down, torch.where(torch.isinf(lo), beta / 2.0,
                                          (beta + lo) / 2.0), beta))
    p = torch.exp(-dist * beta) * off
    s = p.sum(1, keepdim=True)
    p = p / torch.where(s == 0.0, torch.full_like(s, 1e-8), s)
    p = p + p.T
    p = p / torch.clamp(p.sum(), min=_EPS)
    return torch.clamp(p, min=_EPS) * off


def _pca_init(x: torch.Tensor) -> torch.Tensor:
    """The first two principal components' scores, scaled so that the first
    has standard deviation 1e-4 (sklearn's ``init="pca"``)."""
    xc = (x - x.mean(0)).double()
    _, _, vh = torch.linalg.svd(xc, full_matrices=False)
    y = xc @ vh[:2].T
    return (y / y[:, 0].std(unbiased=False) * 1e-4).float()


def tsne(x, *, perplexity: float = 30.0, seed: int = 0, init: str = "pca",
         device="cpu") -> np.ndarray:
    """Exact-gradient 2-D t-SNE of ``x`` [N, D] on ``device``; returns the
    [N, 2] float32 embedding. ``init`` is "pca" or "random" (normal with
    std 1e-4 from ``seed``)."""
    x = torch.as_tensor(np.asarray(x, np.float32), device=device)
    n = x.shape[0]
    p = _joint_probabilities(x, perplexity).float()
    if init == "pca":
        y = _pca_init(x)
    elif init == "random":
        gen = torch.Generator().manual_seed(seed)
        y = (torch.randn(n, 2, generator=gen) * 1e-4).to(device)
    else:
        raise ValueError(f"unknown init {init!r}")
    off = ~torch.eye(n, dtype=torch.bool, device=device)
    lr = max(n / _EXAGGERATION / 4.0, 50.0)

    def descend(y, p, momentum, start, stop, patience):
        """sklearn's ``_gradient_descent``: momentum and per-coordinate
        gains from a standing start; every 50 iterations
        the KL divergence and the gradient norm decide whether to stop."""
        update = torch.zeros_like(y)
        gains = torch.ones_like(y)
        best_error, best_iter = math.inf, start
        it = start
        for it in range(start, stop):
            w = (1.0 / (1.0 + _sq_dists(y, y))) * off
            q = torch.clamp(w / w.sum(dtype=torch.float64).float(), min=_EPS)
            pq = (p - q) * w
            grad = 4.0 * (pq.sum(1, keepdim=True) * y - pq @ y)
            inc = update * grad < 0.0
            gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_(min=0.01)
            grad = grad * gains
            update = momentum * update - lr * grad
            y = y + update
            if (it + 1) % _CHECK_EVERY == 0:
                error = float((p * torch.log(torch.clamp(p, min=_EPS) / q)
                               ).sum(dtype=torch.float64))
                if error < best_error:
                    best_error, best_iter = error, it
                elif it - best_iter > patience:
                    break
                if float(grad.norm()) <= 1e-7:
                    break
        return y, it

    y, it = descend(y, p * _EXAGGERATION, 0.5, 0, _EXPLORATION_ITERS,
                    _EXPLORATION_ITERS)
    y, _ = descend(y, p, 0.8, it + 1, _MAX_ITERS, 300)
    return y.cpu().numpy()


def _kmeans_plusplus(x: torch.Tensor, k: int,
                     rng: np.random.Generator) -> torch.Tensor:
    """sklearn's greedy k-means++: the first centre uniformly, then at each
    step ``2 + int(ln k)`` candidates drawn in proportion to the squared
    distance to the nearest centre, keeping the one that lowers the
    potential most."""
    n = x.shape[0]
    trials = 2 + int(math.log(k))
    centers = [int(rng.integers(n))]
    closest = _sq_dists(x[centers[0]][None], x)[0].double()
    pot = float(closest.sum())
    for _ in range(1, k):
        cum = torch.cumsum(closest, 0)
        draws = torch.as_tensor(rng.random(trials) * pot,
                                dtype=torch.float64, device=x.device)
        cand = torch.searchsorted(cum, draws).clamp_(max=n - 1)
        d = torch.minimum(closest[None], _sq_dists(x[cand], x).double())
        pots = d.sum(1)
        best = int(torch.argmin(pots))
        pot = float(pots[best])
        closest = d[best]
        centers.append(int(cand[best]))
    return x[centers].clone()


def _lloyd(x: torch.Tensor, centers: torch.Tensor, tol: float,
           max_iter: int = 300) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Lloyd's iterations to a centre shift of at most ``tol`` (or unchanged
    labels); an empty cluster takes the point farthest from its centre.
    Returns labels, centres and inertia."""
    k = centers.shape[0]
    x64 = x.double()
    labels = None
    for _ in range(max_iter):
        d = _sq_dists(x, centers)
        new_labels = d.argmin(1)
        if labels is not None and torch.equal(new_labels, labels):
            break
        labels = new_labels
        sums = torch.zeros(k, x.shape[1], dtype=torch.float64,
                           device=x.device).index_add_(0, labels, x64)
        counts = torch.bincount(labels, minlength=k)
        empty = torch.nonzero(counts == 0)[:, 0]
        if len(empty):
            far = torch.argsort(d.gather(1, labels[:, None])[:, 0],
                                descending=True)[:len(empty)]
            sums[empty] = x64[far]
            counts[empty] = 1
        new = (sums / counts[:, None]).float()
        shift = float(((new - centers).double() ** 2).sum())
        centers = new
        if shift <= tol:
            labels = _sq_dists(x, centers).argmin(1)
            break
    d = _sq_dists(x, centers)
    labels = d.argmin(1)
    inertia = float(d.gather(1, labels[:, None]).sum(dtype=torch.float64))
    return labels, centers, inertia


def kmeans(x, k: int, *, n_init: int = 4, seed: int = 0, device="cpu"
           ) -> Tuple[np.ndarray, np.ndarray, float]:
    """k-means of ``x`` [N, D] into ``k`` clusters on ``device``: the best
    inertia of ``n_init`` k-means++ + Lloyd runs. Returns (labels int64
    [N], centres float32 [k, D], inertia)."""
    x = torch.as_tensor(np.asarray(x, np.float32), device=device)
    tol = 1e-4 * float(x.double().var(0, unbiased=False).mean())
    rng = np.random.default_rng(seed)
    best = None
    for _ in range(n_init):
        run = _lloyd(x, _kmeans_plusplus(x, k, rng), tol)
        if best is None or run[2] < best[2]:
            best = run
    labels, centers, inertia = best
    return labels.cpu().numpy(), centers.cpu().numpy(), inertia


def silhouette(x, labels, *, chunk: int = 2048, device="cpu") -> float:
    """The mean silhouette coefficient of ``x`` [N, D] under ``labels``
    (sklearn's ``silhouette_score``): Euclidean distances in float64,
    ``chunk`` rows at a time; a point alone in its cluster scores 0."""
    x = torch.as_tensor(np.asarray(x), device=device).double()
    uniq, lab = np.unique(np.asarray(labels), return_inverse=True)
    k = len(uniq)
    n = x.shape[0]
    if not 2 <= k <= n - 1:
        raise ValueError(f"silhouette needs 2 <= labels <= N - 1, got {k} "
                         f"labels for {n} points")
    lab = torch.as_tensor(lab, device=device)
    onehot = torch.nn.functional.one_hot(lab, k).double()
    sizes = onehot.sum(0)
    sq = (x * x).sum(1)
    total = torch.zeros((), dtype=torch.float64, device=device)
    for s in range(0, n, chunk):
        xc = x[s:s + chunk]
        d2 = sq[s:s + chunk, None] + sq[None, :] - 2.0 * (xc @ x.T)
        rows = torch.arange(len(xc), device=device)
        d2[rows, rows + s] = 0.0
        per_cluster = d2.clamp_(min=0.0).sqrt_() @ onehot   # [c, k]
        own = lab[s:s + chunk]
        own_size = sizes[own]
        a = per_cluster.gather(1, own[:, None])[:, 0] / (own_size - 1).clamp(
            min=1)
        mean_other = per_cluster / sizes[None, :]
        mean_other.scatter_(1, own[:, None], math.inf)
        b = mean_other.min(1).values
        sil = (b - a) / torch.maximum(a, b)
        sil = torch.where(own_size > 1, torch.nan_to_num(sil), 0.0)
        total += sil.sum()
    return float(total / n)
