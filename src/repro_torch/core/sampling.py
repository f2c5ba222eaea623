"""Progressive + importance sampling (paper §3.3).

Each iteration draws ``ceil(schedule[i] * m)`` rows: the worst-fit points from
the previous iteration's TLB evaluation are carried forward (importance
sampling, bounded by ``reuse_fraction`` of the sample), and the remainder is
drawn uniformly without replacement from the rest of the population.
"""

from __future__ import annotations

import math

import numpy as np


def schedule_sizes(m: int, schedule) -> list[int]:
    """Absolute sample sizes for the progressive schedule (deduplicated,
    nondecreasing, capped at m)."""
    sizes: list[int] = []
    for frac in schedule:
        s = min(m, max(2, math.ceil(frac * m)))
        if not sizes or s > sizes[-1]:
            sizes.append(s)
    return sizes


def draw_sample(
    m: int,
    size: int,
    rng: np.random.Generator,
    hard_points: np.ndarray | None = None,
    reuse_fraction: float = 0.10,
) -> np.ndarray:
    """Compose the iteration's sample: carried worst-fit points + uniform fill."""
    size = min(size, m)
    carried = np.zeros(0, dtype=np.int64)
    if hard_points is not None and hard_points.size > 0 and reuse_fraction > 0:
        budget = max(1, int(reuse_fraction * size))
        carried = np.unique(hard_points.astype(np.int64))[:budget]
    remaining = size - carried.size
    if remaining > 0:
        pool = np.setdiff1d(np.arange(m, dtype=np.int64), carried, assume_unique=False)
        fill = rng.choice(pool, size=min(remaining, pool.size), replace=False)
        idx = np.concatenate([carried, fill])
    else:
        idx = carried[:size]
    rng.shuffle(idx)
    return idx


def hard_points_from_scores(
    points: np.ndarray, scores: np.ndarray, quantile: float = 0.10
) -> np.ndarray:
    """Bottom-quantile (worst TLB) points to carry into the next sample."""
    if points.size == 0:
        return points
    cutoff = np.quantile(scores, quantile)
    return points[scores <= cutoff]
