"""1-NN retrieval of the PyTorch port against the JAX package, on the CPU.

Indices must be identical. The data is checked for margin first: for every
row the gap between the nearest and the second-nearest squared distance
(float64) must exceed ``GAP``, far above the float32 rounding of the
||q||^2 + ||x||^2 - 2 q.x expansion both packages use.
"""

import numpy as np
import pytest

from repro.analytics import knn_retrieval_accuracy as ref_accuracy
from repro.analytics import nearest_neighbors as ref_nn
from repro.analytics import nearest_neighbors_legacy as ref_nn_legacy
from repro.analytics import pairwise_knn as ref_pairwise_knn
from repro_torch.analytics import (
    knn_retrieval_accuracy,
    nearest_neighbors,
    nearest_neighbors_legacy,
    pairwise_knn,
)

GAP = 1e-3


def _data(m, d, seed):
    x = np.random.default_rng(seed).normal(size=(m, d)).astype(np.float32)
    if m >= 3:
        x64 = x.astype(np.float64)
        d2 = ((x64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        two = np.sort(d2, axis=1)[:, :2]
        assert (two[:, 1] - two[:, 0] > GAP).all(), "test data has a near-tie"
    return x


@pytest.mark.parametrize("m,d", [(1, 4), (2, 3), (63, 5), (97, 16), (131, 8), (300, 24)])
def test_nearest_neighbors_match_reference(m, d):
    x = _data(m, d, seed=m)
    want = ref_nn(x)
    got = nearest_neighbors(x, device="cpu")
    assert got.dtype == np.int32 and got.shape == (m,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(nearest_neighbors_legacy(x, block=64, device="cpu"), want)
    np.testing.assert_array_equal(ref_nn_legacy(x, block=64), want)


def test_pairwise_knn_distances_match_reference():
    x = _data(200, 12, seed=4)
    idx, d2 = pairwise_knn(x, device="cpu")
    ridx, rd2 = ref_pairwise_knn(x, use_kernels=True)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_allclose(d2, rd2, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d2, ((x - x[idx]) ** 2).sum(1), rtol=1e-4, atol=1e-4)


def test_single_point_returns_self():
    """m = 1 has no other row: index 0 (itself), as in the reference."""
    one = _data(1, 5, seed=0)
    assert nearest_neighbors(one, device="cpu").tolist() == [0]
    assert nearest_neighbors_legacy(one, device="cpu").tolist() == [0]
    idx, d2 = pairwise_knn(one, device="cpu")
    assert idx.tolist() == [0] and np.isinf(d2[0])


def test_retrieval_accuracy_matches_reference():
    x = _data(150, 6, seed=5)
    labels = np.random.default_rng(6).integers(0, 3, size=150)
    assert knn_retrieval_accuracy(x, labels, device="cpu") == ref_accuracy(x, labels)
