"""Gaussian kernel density estimation — a pairwise-distance downstream task
(mentioned in §1 alongside k-NN/k-Means as TLB-sensitive analytics).

``gaussian_kde`` is a thin adapter over one pairwise scan
(``analytics.pairwise``; kernel K5 on a CUDA device). ``gaussian_kde_legacy``
keeps the per-block host loop as the parity oracle (same math, so parity is
tight — only the summation order differs)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import resolve_device


def gaussian_kde_legacy(
    x: np.ndarray,
    queries: np.ndarray | None = None,
    bandwidth: float = 1.0,
    block: int = 1024,
    *,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """The host loop: one (block, m) tile of densities per step, each
    brought back to the host before the next."""
    device = resolve_device(device)
    xs = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
    qs = xs if queries is None else torch.from_numpy(
        np.ascontiguousarray(queries, dtype=np.float32)
    ).to(device)
    inv = torch.tensor(1.0 / (2.0 * bandwidth * bandwidth), dtype=torch.float32)
    sq_x = torch.sum(xs * xs, dim=1)
    out = []
    for a in range(0, qs.shape[0], block):
        xq = qs[a : a + block]
        sq_q = torch.sum(xq * xq, dim=1, keepdim=True)
        d2 = torch.clamp(sq_q + sq_x[None, :] - 2.0 * xq @ xs.T, min=0.0)
        out.append(torch.mean(torch.exp(-d2 * inv), dim=1).cpu().numpy())
    return np.concatenate(out)


def gaussian_kde(
    x: np.ndarray,
    queries: np.ndarray | None = None,
    bandwidth: float = 1.0,
    *,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Mean Gaussian kernel density at each query point (unnormalized)."""
    from repro_torch.analytics.pairwise import pairwise_kde

    return pairwise_kde(x, queries, bandwidth, device=device)
