"""The port's appearance clustering (``cluster.py``) against the JAX
package's (``scripts/encode_features.py::cluster``, scikit-learn's KMeans
and TSNE; scikit-learn is imported here only), on the CPU. It cannot
match scikit-learn bit for bit, so it is held to:

- the k=1 centre: the class mean within 1e-6;
- inertia at most 1.02x scikit-learn's ``KMeans(n_init=10,
  random_state=0)`` on the same features;
- the t-SNE order: a deterministic permutation of the k-means centres
  whose path through neighbours is at most 1.25x as long as the path in
  scikit-learn's TSNE order of the same centres;
- the file: ``np.save`` of a dict class -> (k, rep) float32, as JAX's.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans
from sklearn.manifold import TSNE

from scene_generation_tpu_torch.cluster import cluster, kmeans

from _torch_port import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _blobs(seed: int, n: int, d: int, centres: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    c = rng.randn(centres, d) * 3
    return (c[rng.randint(centres, size=n)] + rng.randn(n, d)).astype(
        np.float32)


def _inertia(x: np.ndarray, c: np.ndarray) -> float:
    x, c = x.astype(np.float64), c.astype(np.float64)
    return float(((x[:, None] - c[None]) ** 2).sum(-1).min(1).sum())


def _path(c: np.ndarray) -> float:
    return float(np.linalg.norm(np.diff(c.astype(np.float64), axis=0),
                                axis=1).sum())


# Appearance vectors are rep_size = 32 wide (the default Config). In a few
# dimensions both k-means spread several percent from seed to seed.
@pytest.mark.parametrize("n,d,blobs,k", [(300, 32, 0, 100),
                                         (500, 32, 40, 100),
                                         (120, 32, 10, 10), (60, 32, 5, 20),
                                         (40, 32, 3, 3)])
def test_kmeans_inertia_within_two_percent_of_sklearn(n, d, blobs, k):
    x = (_blobs(n + k, n, d, blobs) if blobs else
         np.random.RandomState(k).randn(n, d).astype(np.float32))
    got = cluster({1: x}, k, device="cpu")[1]
    want = KMeans(n_clusters=k, n_init=10, random_state=0).fit(x)
    assert got.shape == (k, d) and got.dtype == np.float32
    assert _inertia(x, got) <= 1.02 * _inertia(x, want.cluster_centers_)


def test_k1_centre_is_the_class_mean():
    feats = {c: _blobs(c, n, 6, 3) for c, n in ((1, 1), (2, 2), (5, 37))}
    table = cluster(feats, 1, device="cpu")
    for c, x in feats.items():
        assert table[c].shape == (1, 6)
        np.testing.assert_allclose(table[c][0], x.astype(np.float64).mean(0),
                                   atol=1e-6, rtol=0)


def test_tsne_order_is_a_short_deterministic_permutation():
    """The ordered table holds the k-means centres (the same restarts,
    drawn from the same seed), in the same order every run, along a path
    no longer than 1.25x scikit-learn's TSNE order of those centres."""
    feats = {3: _blobs(7, 240, 8, 30), 4: _blobs(8, 60, 8, 6)}
    table = cluster(feats, 25, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(
        table.values(), cluster(feats, 25, device="cpu").values()))
    for c, x in feats.items():
        centres, _ = kmeans(torch.from_numpy(x), 25,
                            torch.Generator().manual_seed(0))
        centres = centres.numpy()
        key = lambda a: np.lexsort(a.T[::-1])  # noqa: E731
        np.testing.assert_array_equal(table[c][key(table[c])],
                                      centres[key(centres)])
        sk = TSNE(n_components=1, random_state=0,
                  perplexity=min(30.0, max(2.0, 24 / 3.0))).fit_transform(
                      centres)[:, 0]
        assert _path(table[c]) <= 1.25 * _path(centres[np.argsort(sk)])
        assert _path(table[c]) < _path(centres)      # better than unordered


def test_tables_have_the_jax_file_format(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "jax_encode_features", os.path.join(REPO, "scripts",
                                            "encode_features.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    feats = {1: _blobs(1, 30, 4, 3), 2: _blobs(2, 2, 4, 1),
             6: _blobs(3, 5, 4, 2), 9: np.zeros((0, 4), np.float32)}
    for k in (10, 1):
        got = cluster(feats, k, str(tmp_path / f"port_{k}.npy"),
                      device="cpu")
        want = ref.cluster(feats, k, str(tmp_path / f"jax_{k}.npy"))
        loaded = np.load(tmp_path / f"port_{k}.npy", allow_pickle=True).item()
        assert sorted(loaded) == sorted(got) == sorted(want) == [1, 2, 6]
        for c in want:
            assert loaded[c].dtype == want[c].dtype == np.float32
            assert loaded[c].shape == want[c].shape
            np.testing.assert_array_equal(loaded[c], got[c])
        if k == 1:
            for c in want:
                np.testing.assert_allclose(got[c], want[c], atol=1e-6)


def test_cluster_without_a_device_or_cuda_raises(monkeypatch):
    """Like every entry point, ``cluster`` runs on CUDA unless the caller
    asks for the CPU: with no GPU it raises, never clusters on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster({1: _blobs(1, 4, 3, 1)}, 1)
