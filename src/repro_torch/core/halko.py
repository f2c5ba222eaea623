"""SVD-Halko: randomized truncated SVD (paper Algorithm 3; Halko et al. 2011).

Computes an approximate rank-k factorization in O(mdk + k^2(m+d)) by sketching
the column space with a random Gaussian test matrix, optionally sharpening with
power iteration, then factorizing the small projected panel.

The heavy O(mdk) work is three products, C @ Ω, Cᵀ @ Y and Qᵀ @ C; they go
through the K1 dispatcher (``repro_torch.kernels.matmul.ops``), which reads
the transposed operands in place. The small (k+p)-sized QR/SVD panels stay
on ``torch.linalg`` on the same device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.matmul import ops as mm_ops


def _draw_omega(
    d: int, l: int, generator: torch.Generator, device: torch.device
) -> torch.Tensor:
    """The (d, l) Gaussian test matrix Ω (Alg. 3 line 2). It is drawn on the
    host from a CPU ``generator`` and then moved, so one seed gives the same
    Ω, and so the same basis, on every device."""
    return torch.randn(d, l, generator=generator, dtype=torch.float32).to(device)


def svd_halko(
    c: torch.Tensor,
    k: int,
    generator: torch.Generator,
    oversample: int = 5,
    power_iters: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 3. ``c`` must already be centered. Returns (V[:, :k], sigma).

    V is (d, k): the approximate top-k right singular vectors (PCA projection).
    """
    m, d = c.shape
    l = min(k + oversample, m, d)
    omega = _draw_omega(d, l, generator, c.device).to(c.dtype)
    y = mm_ops.matmul(c, omega)  # (m, l)
    # Power iteration (line 3): Y = (C Cᵀ)^q C Ω, with QR re-orthonormalization
    # between steps for numerical stability (without it float32 loses the
    # small singular directions).
    for _ in range(power_iters):
        y, _ = torch.linalg.qr(y)
        z = mm_ops.matmul(c.T, y)  # (d, l)
        z, _ = torch.linalg.qr(z)
        y = mm_ops.matmul(c, z)  # (m, l)
    q, _ = torch.linalg.qr(y)  # line 4: (m, l)
    b = mm_ops.matmul(q.T, c)  # line 5: (l, d)
    _, s, vt = torch.linalg.svd(b, full_matrices=False)  # line 6
    return vt[:k].T, s[:k]  # line 7


def svd_halko_np(c, k, seed=0, oversample=5, power_iters=1):
    """Numpy oracle for tests (independent of the PyTorch path)."""
    rng = np.random.default_rng(seed)
    m, d = c.shape
    l = min(k + oversample, m, d)
    omega = rng.normal(size=(d, l)).astype(c.dtype)
    y = c @ omega
    for _ in range(power_iters):
        y, _ = np.linalg.qr(y)
        z, _ = np.linalg.qr(c.T @ y)
        y = c @ z
    q, _ = np.linalg.qr(y)
    b = q.T @ c
    _, s, vt = np.linalg.svd(b, full_matrices=False)
    return vt[:k].T, s[:k]
