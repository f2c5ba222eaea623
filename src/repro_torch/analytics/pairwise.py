"""Pairwise reductions for the downstream analytics.

kNN retrieval, DBSCAN radius queries and Gaussian KDE are each a
row-reduction over the (m_q, m) pairwise squared-distance matrix. On a CUDA
device each scan is one launch of its kernel (K3 1-NN, K4 eps-ball counts
and packed neighbor bits, K5 compensated exp-sum), which carries the
reduction across dataset tiles so the m x m matrix never exists; on the CPU
the plain version materializes it. Each scan moves ``x`` to the device
once and brings its outputs back in one copy.

The JAX package pads rows to tile multiples and shape buckets to bound its
jit compiles; eager PyTorch has none to bound and the kernels mask ragged
edges themselves, so nothing is padded here. Results are unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.pairwise_reduce import ops
from repro_torch.utils import resolve_device


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)


def pairwise_knn(
    x: np.ndarray, *, device: str | torch.device = "cuda"
) -> tuple[np.ndarray, np.ndarray]:
    """Nearest OTHER row per row of ``x``: (indices int32, squared dists).

    Ties keep the first occurrence (lowest index); a single row returns
    itself (index 0) at distance +inf."""
    device = resolve_device(device)
    xt = _to_device(x, device)
    idx, d2 = ops.pairwise_knn_reduce(xt, xt, xt.shape[0])
    return idx.cpu().numpy(), d2.cpu().numpy()


def pairwise_dbscan(
    x: np.ndarray, eps: float, *, device: str | torch.device = "cuda"
) -> tuple[np.ndarray, np.ndarray]:
    """Eps-ball scan: (degree counts int32 (m,), packed uint32 (m, w)).

    Counts and bits INCLUDE the self column (d2=0 is always within eps);
    ``unpack_neighbors`` drops self when decoding. Bit layout is
    little-endian: dataset column c lives at word c//32, bit c%32."""
    device = resolve_device(device)
    xt = _to_device(x, device)
    # float32(eps * eps) — double-precision square, then ONE rounding, as
    # the JAX package computes it; float32(eps)**2 rounds twice and lands
    # 1 ulp off for about half of all eps values
    eps2 = np.float32(float(eps) * float(eps))
    counts, packed = ops.pairwise_dbscan_reduce(xt, xt, xt.shape[0], eps2)
    # the one copy back: counts ride as column 0 beside the words' bits
    both = torch.cat([counts[:, None], packed.view(torch.int32)], dim=1).cpu().numpy()
    return both[:, 0].copy(), np.ascontiguousarray(both[:, 1:]).view(np.uint32)


def pairwise_kde(
    x: np.ndarray,
    queries: np.ndarray | None = None,
    bandwidth: float = 1.0,
    *,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Mean Gaussian kernel density of ``x`` at each query row (unnormalized,
    the mean over the m reference points of exp(-d2 / 2h^2))."""
    device = resolve_device(device)
    xt = _to_device(x, device)
    qt = xt if queries is None else _to_device(queries, device)
    inv = np.float32(1.0 / (2.0 * bandwidth * bandwidth))
    sums, comps = ops.pairwise_kde_reduce(qt, xt, xt.shape[0], inv)
    pair = torch.stack([sums, comps]).cpu().numpy()  # the one copy back
    return kde_from_compensated(pair[0][None, :], pair[1][None, :], xt.shape[0])


def kde_from_compensated(
    sums: np.ndarray, comps: np.ndarray, m: int
) -> np.ndarray:
    """Fold (S, mq) compensated exp-sum pairs into densities.

    The device carries (sum, comp) in f32; the exact value of each partial
    is ``sum + comp``. Folding partials and the final mean in float64 on
    the host keeps the result to ~f32 ulp whatever the summation order."""
    total = (sums.astype(np.float64) + comps.astype(np.float64)).sum(axis=0)
    return (total / float(m)).astype(np.float32)


def unpack_neighbors(packed_row: np.ndarray, p: int, m: int) -> np.ndarray:
    """Decode one packed bitmask row into sorted neighbor indices, self
    excluded — the single-row primitive (``NeighborDecoder`` amortizes the
    unpack over row chunks for the BFS)."""
    bits = np.unpackbits(
        np.ascontiguousarray(packed_row).view(np.uint8), bitorder="little"
    )[:m]
    nbrs = np.flatnonzero(bits)
    return nbrs[nbrs != p]


class NeighborDecoder:
    """Lazy chunked two-level decoder for the packed eps-ball bitmasks.

    The first touch of a row decodes its whole chunk sparsely:

    1. clear the chunk's self bits in the packed domain (the self bit is
       always set, d2 = 0 <= eps^2);
    2. ``np.flatnonzero`` over the packed words — a 32x smaller scan than
       the unpacked matrix;
    3. ``np.unpackbits`` only the nonzero words and turn bit positions into
       global column indices with shift/mask arithmetic;
    4. one ``np.split`` at the per-row counts hands out per-row neighbor
       arrays, ascending — what a per-row ``np.nonzero`` would produce.

    Cost per chunk: O(words + set bits), and untouched chunks are never
    decoded."""

    def __init__(self, packed: np.ndarray, m: int, chunk: int = 1024) -> None:
        self.packed = packed
        self.m = m
        self.chunk = max(int(chunk), 1)
        self._chunks: dict[int, list[np.ndarray]] = {}

    def _decode_chunk(self, c: int) -> list[np.ndarray]:
        a = c * self.chunk
        b = min(a + self.chunk, self.m)
        rows = b - a
        words = np.array(self.packed[a:b])  # copy: self bits cleared below
        wpr = words.shape[1]
        g = np.arange(a, b)
        words[np.arange(rows), g // 32] &= ~np.left_shift(
            np.uint32(1), (g % 32).astype(np.uint32)
        )
        flat = words.ravel()
        wnz = np.flatnonzero(flat)  # the 32x-smaller scan
        bits = np.unpackbits(
            np.ascontiguousarray(flat[wnz]).view(np.uint8),
            bitorder="little",
        )
        pos = np.flatnonzero(bits)
        wloc = pos >> 5  # which nonzero word each set bit belongs to
        cols = (wnz[wloc] % wpr) * 32 + (pos & 31)
        counts = np.bincount(wnz[wloc] // wpr, minlength=rows)
        return np.split(cols, np.cumsum(counts)[:-1])

    def __call__(self, p: int) -> np.ndarray:
        c = p // self.chunk
        got = self._chunks.get(c)
        if got is None:
            got = self._chunks[c] = self._decode_chunk(c)
        return got[p - c * self.chunk]
