"""Basis fitting + search for the lowest TLB-preserving dimension (paper §3.4).

COMPUTE-BASIS (Alg. 4): fit PCA on the sample (via SVD-Halko or full SVD),
then find the smallest k achieving the TLB target. Two search modes:

* ``binary`` — the paper's Algorithm 4: binary search over k in [0, k_{i-1}],
  with EVALUATE-TLB's CI-driven pair doubling at each probe.
* ``prefix`` — one pass computes the TLB CI at every k simultaneously; the
  smallest satisfying k is read off the table.

Both exploit the PCA prefix property (T_k = first k columns of T_{k'}) and TLB
monotonicity in k.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import halko as halko_mod
from repro_torch.core import pca as pca_mod
from repro_torch.core.bucketing import DEFAULT_BUCKETS, ShapeBucketCache
from repro_torch.core.tlb import TLBEstimator
from repro_torch.core.types import DropConfig


@dataclass
class BasisSearchResult:
    v_full: np.ndarray  # (d, cap) — full fitted basis (cached for prefix reuse)
    mean: np.ndarray  # (d,) sample column means
    k: int
    tlb_mean: float
    satisfied: bool
    pairs_used: int
    estimator: TLBEstimator  # retained for importance-sampling reuse


def fit_basis(
    sample: torch.Tensor,
    cap: int,
    cfg: DropConfig,
    generator: torch.Generator,
    bucket: ShapeBucketCache,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fit a rank-``cap`` PCA basis on the sample, on the sample's device.
    Returns (mean (d,), V (d, cap)).

    The sample is zero-padded to its row bucket and centered with a row
    mask: padded rows contribute nothing to the mean and
    stay exactly zero, and zero rows never change the right singular vectors
    (C'ᵀC' = CᵀC). The padded row count enters Halko's sketch width
    l = min(cap + oversample, rows, d), so the JAX package's bases are
    reproduced only with the same padding.
    """
    n, d = sample.shape
    padded = bucket.bucket_rows(n)
    xs = sample
    if padded > n:
        xs = torch.cat([sample, sample.new_zeros((padded - n, d))], dim=0)
    mask = torch.arange(padded, device=sample.device) < n
    mean, c = pca_mod.center_masked(xs, mask)
    if cfg.svd == "full":
        _, _, vt = torch.linalg.svd(c, full_matrices=False)
        v = vt.T[:, :cap]
    else:
        v, _ = halko_mod.svd_halko(
            c,
            cap,
            generator,
            oversample=cfg.halko_oversample,
            power_iters=cfg.halko_power_iters,
        )
    return mean, v


def _binary_search(
    est: TLBEstimator, target: float, cap: int, cfg: DropConfig
) -> tuple[int, float, bool, int]:
    """Alg. 4 COMPUTE-BASIS lines 2-9."""
    low, high = 0, cap
    pairs_used = 0
    while low != high:
        k = (low + high) // 2
        e = est.estimate_at_k(
            k, target, initial_pairs=cfg.initial_pairs, max_pairs=cfg.max_pairs
        )
        pairs_used = max(pairs_used, e.pairs_used)
        if e.mean <= target:  # not good enough: need more components
            low = k + 1
        else:
            high = k
    k = low
    final = est.estimate_at_k(
        k, target, initial_pairs=cfg.initial_pairs, max_pairs=cfg.max_pairs
    )
    pairs_used = max(pairs_used, final.pairs_used)
    return k, final.mean, final.mean >= target, pairs_used


def _prefix_search(
    est: TLBEstimator, target: float, cap: int, cfg: DropConfig
) -> tuple[int, float, bool, int]:
    """All-prefix search: smallest k whose mean TLB clears the target."""
    mean_k, _, _, pairs = est.estimate_all_k(
        target, initial_pairs=cfg.initial_pairs, max_pairs=cfg.max_pairs
    )
    ok = np.nonzero(mean_k[:cap] >= target)[0]
    if ok.size:
        k = int(ok[0]) + 1
        return k, float(mean_k[k - 1]), True, pairs
    return cap, float(mean_k[cap - 1]), False, pairs


def compute_basis(
    x: torch.Tensor,
    sample: torch.Tensor,
    prev_k: int | None,
    cfg: DropConfig,
    generator: torch.Generator,
    rng: np.random.Generator,
) -> BasisSearchResult:
    """COMPUTE-BASIS(X, X_i, B): fit on the sample, evaluate TLB on full-data
    pairs, search for the smallest satisfying k (bounded by k_{i-1}).

    ``x`` (the full data) and ``sample`` live on the device that runs the
    fit and the TLB table; the fit width and rows round through
    ``DEFAULT_BUCKETS`` exactly as in the JAX package.
    """
    m_i, d = sample.shape
    hard_cap = min(d, m_i)
    cap = hard_cap
    if prev_k is not None:
        # §3.4.3: prior satisfying basis of size d' < d bounds the Halko rank
        cap = min(cap, prev_k)
    cap = max(cap, 1)
    # the basis is fitted at the bucketed width; the search below still uses
    # the true cap
    cap_pad = DEFAULT_BUCKETS.bucket_rank(cap, hard_cap)
    mean, v = fit_basis(sample, max(cap_pad, cap), cfg, generator, DEFAULT_BUCKETS)
    est = TLBEstimator(x, v, rng, confidence=cfg.confidence)
    search = _binary_search if cfg.search == "binary" else _prefix_search
    k, tlb_mean, satisfied, pairs = search(est, cfg.target_tlb, cap, cfg)
    return BasisSearchResult(
        v_full=v.cpu().numpy(),
        mean=mean.cpu().numpy(),
        k=max(k, 1),
        tlb_mean=tlb_mean,
        satisfied=satisfied,
        pairs_used=pairs,
        estimator=est,
    )
