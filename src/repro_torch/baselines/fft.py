"""Fourier (FFT) dimensionality reduction — paper baseline (Faloutsos et al.).

Orthonormal DFT is an isometry (Parseval), so keeping any subset of
coefficients is contractive. We expand the rfft of a real series into a REAL
coefficient vector ordered by frequency:

    [Re X_0, sqrt(2) Re X_1, sqrt(2) Im X_1, sqrt(2) Re X_2, ...,  (Nyquist)]

whose prefix of length k is the k-dim FFT representation; the full expansion
preserves L2 norms exactly, so prefixes lower-bound distances (TLB <= 1).
Runtime O(m d log d), host numpy.
"""

from __future__ import annotations

import numpy as np


def fft_real_expansion(x: np.ndarray) -> np.ndarray:
    """(m, d) -> (m, d) real orthonormal Fourier coefficient expansion."""
    x = np.asarray(x, dtype=np.float64)
    m, d = x.shape
    cf = np.fft.rfft(x, axis=1, norm="ortho")  # (m, d//2+1)
    cols = [cf[:, 0].real]  # DC term (weight 1)
    n_half = cf.shape[1]
    for f in range(1, n_half):
        if d % 2 == 0 and f == n_half - 1:
            cols.append(cf[:, f].real)  # Nyquist term (weight 1)
        else:
            cols.append(np.sqrt(2.0) * cf[:, f].real)
            cols.append(np.sqrt(2.0) * cf[:, f].imag)
    out = np.stack(cols, axis=1)[:, :d]
    return out.astype(np.float32)
