"""Johnson-Lindenstrauss Gaussian random projection (Achlioptas 2001).

Data-independent baseline from the paper's introduction: preserves pairwise
distances only in expectation (NOT contractive per-pair), and the JL lemma's
worst-case dimension is what PCA beats by 46x on structured data (§1).
Host numpy, with the JAX package's ``default_rng(seed)`` stream.
"""

from __future__ import annotations

import numpy as np


def jl_operator(d: int, k: int, seed: int = 0) -> np.ndarray:
    """The (d, k) Gaussian projection matrix scaled by 1/sqrt(k)."""
    rng = np.random.default_rng(seed)
    # divide before the float32 cast: a float32-array / python-float would
    # silently promote the operator (and every transform) back to float64
    return (rng.normal(size=(d, k)) / np.sqrt(k)).astype(np.float32)


def jl_transform(x: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """(m, d) -> (m, k) Gaussian random projection scaled by 1/sqrt(k)."""
    return np.asarray(x, dtype=np.float32) @ jl_operator(x.shape[1], k, seed)
