"""Haar discrete wavelet transform — another baseline from the paper's
source study (Ding et al. 2008 compared DWT among the eight methods).

The orthonormal Haar transform is an isometry; coefficients ordered
coarse-to-fine give a NESTED representation (like FFT/PCA prefixes), so
truncation is contractive and the min-k search is a single prefix pass.
Inputs are zero-padded to the next power of two (padding preserves L2).
Host numpy.
"""

from __future__ import annotations

import numpy as np


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def haar_expansion(x: np.ndarray) -> np.ndarray:
    """(m, d) -> (m, 2^ceil(log2 d)) orthonormal Haar coefficients, ordered
    [approximation | detail levels coarse -> fine]."""
    x = np.asarray(x, dtype=np.float64)
    m, d = x.shape
    n = _next_pow2(d)
    buf = np.zeros((m, n), dtype=np.float64)
    buf[:, :d] = x
    out_details = []
    cur = buf
    while cur.shape[1] > 1:
        even, odd = cur[:, 0::2], cur[:, 1::2]
        approx = (even + odd) / np.sqrt(2.0)
        detail = (even - odd) / np.sqrt(2.0)
        out_details.append(detail)
        cur = approx
    # coarse-to-fine: final approximation, then details from coarsest level
    cols = [cur] + out_details[::-1]
    return np.concatenate(cols, axis=1).astype(np.float32)
