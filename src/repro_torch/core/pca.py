"""PCA via truncated SVD (paper Algorithm 1) — the exact / baseline operator."""

from __future__ import annotations

import numpy as np
import torch


def center(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """FIT step: column means and centered matrix C_X (Alg. 1 lines 2-3)."""
    xbar = torch.mean(x, dim=0)
    return xbar, x - xbar


def center_masked(
    x: torch.Tensor, row_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Centering for zero-padded sample buckets.

    Rows with ``row_mask == 0`` are padding; they are excluded from the mean and
    re-zeroed after centering. Zero rows do not change the right singular
    vectors (C'ᵀC' = CᵀC), so padded-bucket PCA is exact for the real rows.
    """
    w = row_mask.to(x.dtype)[:, None]
    denom = torch.clamp_min(torch.sum(w), 1.0)
    xbar = torch.sum(x * w, dim=0) / denom
    return xbar, (x - xbar) * w


def pca_fit_svd(
    x: torch.Tensor, k: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PCA via full SVD. Returns (mean, V[:, :k], singular values).

    V columns are the principal directions; ``(y - mean) @ V`` transforms.
    """
    xbar, c = center(x)
    _, s, vt = torch.linalg.svd(c, full_matrices=False)
    v = vt.T
    if k is not None:
        v = v[:, :k]
        s = s[:k]
    return xbar, v, s


def pca_transform(
    y: torch.Tensor, mean: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """TRANSFORM step (Alg. 1 lines 5-9)."""
    return (y - mean) @ v


def explained_spectrum(x: np.ndarray) -> np.ndarray:
    """Normalized eigenvalue spectrum (paper Fig. 3): eigenvalues of the
    covariance in decreasing order, normalized to sum to 1."""
    x = np.asarray(x, dtype=np.float64)
    c = x - x.mean(axis=0)
    s = np.linalg.svd(c, compute_uv=False)
    ev = s**2
    return ev / max(ev.sum(), 1e-30)
