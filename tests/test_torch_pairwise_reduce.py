"""Kernels K4 (DBSCAN eps-ball) and K5 (Gaussian KDE) of the PyTorch port,
and the packed-bit decoders, on the CPU.

Each kernel's plain PyTorch version against the JAX package's Pallas kernel
in interpret mode, on that package's sweep shapes (``tests/test_kernels.py``)
plus ragged dataset sizes around the 32-bit word, with inputs made by numpy
from a seed. Tolerances:

* K4 counts and packed words are exact. The data is checked first for
  margin: no pair's float64 d2 lies within ``EPS_MARGIN`` (relative) of
  eps^2, far above the float32 rounding of the d2 expansion, where the two
  packages could decide a pair differently. The Pallas kernel pads its
  width to its tile; the extra words must be zero.
* K5: ``sums + comps`` in float64 within rtol 2e-5, atol 1e-6 (the
  reference sweep's own tolerance): both sum ~100 float32 terms in another
  order, a few ulps each.

The kernels themselves run only on a CUDA GPU
(``tests/test_torch_kernels_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analytics.pairwise import NeighborDecoder as RefDecoder
from repro.analytics.pairwise import unpack_neighbors as ref_unpack
from repro.kernels.pairwise_reduce.pairwise_reduce import (
    pairwise_dbscan_pallas,
    pairwise_kde_pallas,
)
from repro_torch.analytics.pairwise import NeighborDecoder, unpack_neighbors
from repro_torch.kernels.pairwise_reduce import ops

# the reference sweep's shapes and interpret-mode blocks, plus ragged mk
# around the 32-bit word
PR_SHAPES = [(32, 32, 8), (48, 80, 16), (33, 61, 7), (1, 16, 4), (3, 3, 2)]
RAGGED = [(31, 31, 5), (33, 33, 5), (20, 63, 6), (97, 97, 3)]
PR_BLOCKS = dict(block_q=16, block_k=32)
EPS2 = 1.5**2  # tests/test_kernels.py
INV_TWO_H2 = 0.5
EPS_MARGIN = 1e-4
KDE_RTOL, KDE_ATOL = 2e-5, 1e-6


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _assert_margin(xq, x, eps2):
    q64, x64 = xq.astype(np.float64), x.astype(np.float64)
    d2 = ((q64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)
    near = np.abs(d2 - eps2) <= EPS_MARGIN * eps2
    assert not near.any(), f"test data has {int(near.sum())} pairs at the eps boundary"


@pytest.mark.parametrize("mq,mk,d", PR_SHAPES + RAGGED)
def test_pairwise_dbscan_plain_matches_pallas(mq, mk, d):
    x = _normal(9 + mk, (mk, d))
    _assert_margin(x[:mq], x, EPS2)
    want_c, want_p = pairwise_dbscan_pallas(
        jnp.asarray(x[:mq]), jnp.asarray(x), mk, EPS2, interpret=True, **PR_BLOCKS
    )
    tx = torch.from_numpy(x)
    got_c, got_p = ops.pairwise_dbscan_reduce(tx[:mq], tx, mk, np.float32(EPS2))
    assert got_c.dtype == torch.int32 and got_p.dtype == torch.uint32
    assert got_p.shape == (mq, -(-mk // 32))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    got_p, want_p = got_p.numpy(), np.asarray(want_p)
    w = got_p.shape[1]
    np.testing.assert_array_equal(got_p, want_p[:, :w])
    assert not want_p[:, w:].any()
    tail = mk % 32
    if tail:  # bits for columns >= mk are zero
        assert not (got_p[:, -1] >> np.uint32(tail)).any()


def test_pairwise_dbscan_plain_excludes_columns_past_m():
    x = _normal(11, (70, 4))
    tx = torch.from_numpy(x)
    counts, packed = ops.pairwise_dbscan_reduce(tx, tx, 40, np.float32(9.0))
    bits = np.unpackbits(packed.numpy().view(np.uint8), axis=1, bitorder="little")
    assert not bits[:, 40:].any()
    np.testing.assert_array_equal(counts.numpy(), bits.sum(1))
    assert (bits[np.arange(40), np.arange(40)] == 1).all()  # self included


@pytest.mark.parametrize("mq,mk,d", PR_SHAPES + RAGGED)
def test_pairwise_kde_plain_matches_pallas(mq, mk, d):
    x = _normal(10 + mk, (mk, d))
    sums, comps = pairwise_kde_pallas(
        jnp.asarray(x[:mq]), jnp.asarray(x), mk, INV_TWO_H2, interpret=True, **PR_BLOCKS
    )
    want = np.asarray(sums, np.float64) + np.asarray(comps, np.float64)
    tx = torch.from_numpy(x)
    got_s, got_c = ops.pairwise_kde_reduce(tx[:mq], tx, mk, np.float32(INV_TWO_H2))
    assert got_s.dtype == torch.float32 and not got_c.any()
    got = got_s.numpy().astype(np.float64) + got_c.numpy()
    np.testing.assert_allclose(got, want, rtol=KDE_RTOL, atol=KDE_ATOL)


def test_pairwise_kde_plain_separate_queries_and_m():
    """Queries that are not dataset rows, and columns >= m excluded."""
    x, q = _normal(12, (50, 6)), _normal(13, (7, 6))
    sums, comps = pairwise_kde_pallas(
        jnp.asarray(q), jnp.asarray(x), 45, INV_TWO_H2, interpret=True, **PR_BLOCKS
    )
    want = np.asarray(sums, np.float64) + np.asarray(comps, np.float64)
    got_s, _ = ops.pairwise_kde_reduce(torch.from_numpy(q), torch.from_numpy(x), 45, INV_TWO_H2)
    np.testing.assert_allclose(got_s.numpy(), want, rtol=KDE_RTOL, atol=KDE_ATOL)


@pytest.mark.parametrize("m", [1, 31, 33, 100])
def test_decoders_match_reference(m):
    rng = np.random.default_rng(m)
    words = -(-m // 32)
    packed = rng.integers(0, 2**32, size=(m, words), dtype=np.uint64).astype(np.uint32)
    if m % 32:  # the scans never set bits past m
        packed[:, -1] &= np.uint32((1 << (m % 32)) - 1)
    got, want = NeighborDecoder(packed, m, chunk=16), RefDecoder(packed, m, chunk=16)
    for p in range(m):
        np.testing.assert_array_equal(unpack_neighbors(packed[p], p, m), ref_unpack(packed[p], p, m))
        np.testing.assert_array_equal(got(p), want(p))
        np.testing.assert_array_equal(got(p), unpack_neighbors(packed[p], p, m))
