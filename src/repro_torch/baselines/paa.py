"""Piecewise Aggregate Approximation (Keogh et al. 2001) — paper baseline.

PAA splits each length-d series into k contiguous segments and represents each
segment by its mean. With per-segment sqrt(length) scaling the transform is
contractive (Jensen: L * mean^2 <= sum of squares), so TLB <= 1 holds exactly.
Runtime O(md) — the fastest method in the paper's comparison (Fig. 2).
Host numpy.
"""

from __future__ import annotations

import numpy as np


def _segments(d: int, k: int) -> list[tuple[int, int]]:
    """k near-equal contiguous segments covering [0, d)."""
    bounds = np.linspace(0, d, k + 1).round().astype(int)
    return [(bounds[s], bounds[s + 1]) for s in range(k) if bounds[s + 1] > bounds[s]]


def paa_transform(x: np.ndarray, k: int) -> np.ndarray:
    """(m, d) -> (m, k') lower-bounding PAA representation (k' <= k)."""
    x = np.asarray(x)
    d = x.shape[1]
    segs = _segments(d, min(k, d))
    cols = [
        x[:, a:b].mean(axis=1) * np.sqrt(float(b - a)) for a, b in segs
    ]
    return np.stack(cols, axis=1).astype(np.float32)
