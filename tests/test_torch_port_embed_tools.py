"""The port's t-SNE, k-means and silhouette (``analyze/embed_tools.py``)
against sklearn's, which the JAX analysis suite calls: the silhouette
equal within 1e-6 on the same labels; k-means inertia at most 1.01x that
of ``KMeans(n_init=4)``; t-SNE's trustworthiness (k = 10) at least
sklearn ``TSNE``'s - 0.02. Their random draws differ from sklearn's, so
only the quality is held for those two."""

import numpy as np
import pytest
from sklearn.cluster import KMeans
from sklearn.datasets import make_blobs
from sklearn.manifold import TSNE, trustworthiness
from sklearn.metrics import silhouette_score

from primekg_rgcn_tpu_torch.analyze import embed_tools
from port_analysis_data import one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _blobs(n, centers, dim, seed, std=1.0):
    x, y = make_blobs(n_samples=n, centers=centers, n_features=dim,
                      cluster_std=std, random_state=seed)
    return x.astype(np.float32), y


@pytest.mark.parametrize("seed,k,chunk", [(0, 6, 64), (1, 3, 1000),
                                          (2, 9, 7)])
def test_silhouette_equals_sklearn(seed, k, chunk):
    x, _ = _blobs(400, k, 16, seed, std=3.0)
    labels = np.random.default_rng(seed).integers(0, k, len(x))
    labels[:k] = np.arange(k)
    got = embed_tools.silhouette(x, labels, chunk=chunk)
    assert abs(got - silhouette_score(x, labels)) <= 1e-6


def test_silhouette_scores_a_singleton_cluster_zero_as_sklearn():
    x, _ = _blobs(50, 2, 4, 3)
    labels = (x[:, 0] > np.median(x[:, 0])).astype(int)
    labels[7] = 2   # alone in its cluster
    assert abs(embed_tools.silhouette(x, labels) -
               silhouette_score(x, labels)) <= 1e-6
    with pytest.raises(ValueError, match="labels"):
        embed_tools.silhouette(x, np.zeros(len(x), int))


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_inertia_within_1_percent_of_sklearn(seed):
    x, _ = _blobs(600, 6, 16, seed)
    labels, centers, inertia = embed_tools.kmeans(x, 6, n_init=4, seed=seed)
    want = KMeans(n_clusters=6, n_init=4, random_state=seed).fit(x).inertia_
    assert inertia <= 1.01 * want
    # The inertia is the labelling's own, and every point sits with its
    # nearest centre.
    d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(labels, d.argmin(1))
    assert abs(inertia - d.min(1).sum()) <= 1e-4 * inertia


def test_kmeans_keeps_every_cluster_when_k_is_near_n():
    x, _ = _blobs(30, 3, 4, 5)
    labels, centers, _ = embed_tools.kmeans(x, 10, seed=0)
    assert centers.shape == (10, 4)
    assert len(np.unique(labels)) == 10


def test_tsne_trustworthiness_at_least_sklearns():
    x, _ = _blobs(300, 5, 16, 1)
    got = embed_tools.tsne(x, perplexity=30.0, seed=0)
    want = TSNE(n_components=2, random_state=0, perplexity=30.0,
                init="pca").fit_transform(x)
    assert got.shape == (300, 2) and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert trustworthiness(x, got, n_neighbors=10) >= \
        trustworthiness(x, want, n_neighbors=10) - 0.02


def test_tsne_random_init_is_seeded():
    x, _ = _blobs(60, 3, 8, 2)
    a = embed_tools.tsne(x, perplexity=10.0, seed=3, init="random")
    b = embed_tools.tsne(x, perplexity=10.0, seed=3, init="random")
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="init"):
        embed_tools.tsne(x, perplexity=10.0, init="spectral")
