"""DBSCAN and Gaussian KDE of the PyTorch port against the JAX package, on
the CPU.

* DBSCAN labels must be identical. Both packages share the BFS order, so
  labels agree whenever every pair falls on the same side of eps^2 in both.
  Each dataset is checked for margin first: no pair's float64 d2 lies
  within ``EPS_MARGIN`` (relative) of eps^2. (The JAX package computes d2
  directly at d <= 4 and by the expansion above; the port always expands;
  both are within ~1e-6 relative of the float64 value here.)
* KDE densities within rtol ``KDE_RTOL``: the port's plain scan sums the
  m float32 exponentials in one pass and the reference carries a
  compensated sum, so the two differ by the float32 summation error of at
  most a few hundred terms.
"""

import numpy as np
import pytest
import torch

from repro.analytics import dbscan as ref_dbscan
from repro.analytics import gaussian_kde as ref_kde
from repro.analytics import pairwise_dbscan as ref_pairwise_dbscan
from repro_torch.analytics import (
    dbscan,
    dbscan_legacy,
    gaussian_kde,
    gaussian_kde_legacy,
    pairwise_dbscan,
)
from repro_torch.kernels.pairwise_reduce.ref import pairwise_dbscan_ref

EPS_MARGIN = 1e-4
KDE_RTOL = 1e-5


def _assert_margin(x, eps):
    x64 = x.astype(np.float64)
    d2 = ((x64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)
    near = np.abs(d2 - eps * eps) <= EPS_MARGIN * eps * eps
    assert not near.any(), f"test data has {int(near.sum())} pairs at the eps boundary"


@pytest.fixture(scope="module")
def blobs():
    """Two tight clusters and sparse noise candidates, with a ragged tail
    (130 % 32 != 0) — the JAX package's DBSCAN parity data."""
    rng = np.random.default_rng(0)
    return np.concatenate(
        [
            rng.normal(0, 0.12, size=(61, 3)),
            rng.normal(4, 0.12, size=(49, 3)),
            rng.uniform(-8, 8, size=(20, 3)),
        ]
    ).astype(np.float32)


@pytest.fixture(scope="module")
def xdup():
    """131 x 8 with an exact duplicate row (7 = 3) and a near duplicate
    (9 = 3 + 1e-4)."""
    x = np.random.default_rng(3).normal(size=(131, 8)).astype(np.float32)
    x[7] = x[3]
    x[9] = x[3] + 1e-4
    return x


@pytest.mark.parametrize("min_samples", [2, 4, 8])
def test_dbscan_matches_reference_on_blobs(blobs, min_samples):
    _assert_margin(blobs, 0.6)
    want = ref_dbscan(blobs, eps=0.6, min_samples=min_samples, block=64)
    got = dbscan(blobs, eps=0.6, min_samples=min_samples, device="cpu")
    assert got.dtype == np.int64 and got.shape == (130,)
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist()) - {-1}) >= 2  # the blobs are found
    np.testing.assert_array_equal(
        dbscan_legacy(blobs, eps=0.6, min_samples=min_samples, block=64, device="cpu"), want
    )


@pytest.mark.parametrize("eps,min_samples", [(1.5, 3), (3.0, 5)])
def test_dbscan_matches_reference_with_duplicates(xdup, eps, min_samples):
    _assert_margin(xdup, eps)
    want = ref_dbscan(xdup, eps=eps, min_samples=min_samples, block=32)
    np.testing.assert_array_equal(dbscan(xdup, eps=eps, min_samples=min_samples, device="cpu"), want)
    np.testing.assert_array_equal(
        dbscan_legacy(xdup, eps=eps, min_samples=min_samples, block=32, device="cpu"), want
    )
    counts, packed = pairwise_dbscan(xdup, eps, device="cpu")
    want_c, want_p = ref_pairwise_dbscan(xdup, eps, 32, 32)
    np.testing.assert_array_equal(counts, want_c)
    np.testing.assert_array_equal(packed, want_p[:, : packed.shape[1]])


def test_dbscan_single_point():
    one = np.zeros((1, 4), np.float32)
    want = ref_dbscan(one, eps=0.5, min_samples=2)
    np.testing.assert_array_equal(dbscan(one, eps=0.5, min_samples=2, device="cpu"), want)
    np.testing.assert_array_equal(dbscan_legacy(one, eps=0.5, min_samples=2, device="cpu"), want)
    counts, packed = pairwise_dbscan(one, 0.5, device="cpu")
    assert counts.tolist() == [1] and packed.tolist() == [[1]]


def test_dbscan_eps2_is_rounded_once():
    """eps^2 is float32(eps * eps) — one rounding of the double square, as
    the JAX package computes it. On an eps where float32(eps)**2 is one ulp
    smaller, a pair at exactly the one-rounding eps^2 is a neighbor."""
    for eps in np.linspace(0.3, 3.0, 2001):
        once = np.float32(float(eps) * float(eps))
        twice = np.float32(eps) * np.float32(eps)
        t = np.sqrt(once, dtype=np.float32)
        if twice < once and t * t == once:
            break
    else:
        pytest.fail("no eps with distinct roundings found")
    x = np.array([[0.0], [t]], dtype=np.float32)  # d2 = t * t = once exactly
    counts, _ = pairwise_dbscan(x, float(eps), device="cpu")
    assert counts.tolist() == [2, 2]
    np.testing.assert_array_equal(counts, ref_pairwise_dbscan(x, float(eps))[0])
    tx = torch.from_numpy(x)
    twice_counts, _ = pairwise_dbscan_ref(tx, tx, 2, twice)
    assert twice_counts.tolist() == [1, 1]


def test_kde_matches_reference(xdup):
    want = ref_kde(xdup, bandwidth=1.3)
    got = gaussian_kde(xdup, bandwidth=1.3, device="cpu")
    assert got.dtype == np.float32 and got.shape == (131,)
    np.testing.assert_allclose(got, want, rtol=KDE_RTOL)
    np.testing.assert_allclose(
        gaussian_kde_legacy(xdup, bandwidth=1.3, block=32, device="cpu"), got, rtol=KDE_RTOL
    )


def test_kde_separate_queries_match_reference(xdup):
    queries = np.random.default_rng(4).normal(size=(45, 8)).astype(np.float32)
    want = ref_kde(xdup, queries, bandwidth=2.0)
    got = gaussian_kde(xdup, queries, bandwidth=2.0, device="cpu")
    assert got.shape == (45,)
    np.testing.assert_allclose(got, want, rtol=KDE_RTOL)
    np.testing.assert_allclose(
        gaussian_kde_legacy(xdup, queries, bandwidth=2.0, block=16, device="cpu"), got,
        rtol=KDE_RTOL,
    )
