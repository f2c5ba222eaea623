"""Brute-force k-NN retrieval (the paper's end-to-end downstream task, §4.4).

The paper's "2-NN retrieval" = for every point, retrieve its single nearest
OTHER point (self excluded) and check label agreement. Runtime O(m^2 k) —
exactly the shape of DROP's default cost model.

``nearest_neighbors`` is a thin adapter over one pairwise scan
(``analytics.pairwise``). The block-by-block host loop survives as
``nearest_neighbors_legacy``, the parity oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import resolve_device


def _nn_block(xq: torch.Tensor, x: torch.Tensor, start: int) -> torch.Tensor:
    """Nearest neighbor of each row of xq among rows of x, self excluded
    (mask + argmin; argmin keeps the first occurrence on ties)."""
    sq_q = torch.sum(xq * xq, dim=1, keepdim=True)
    sq_x = torch.sum(x * x, dim=1)
    d2 = sq_q + sq_x[None, :] - 2.0 * xq @ x.T  # (b, m)
    rows = start + torch.arange(xq.shape[0], device=x.device)
    cols = torch.arange(x.shape[0], device=x.device)
    d2 = torch.where(rows[:, None] == cols[None, :], torch.inf, d2)
    return torch.argmin(d2, dim=1)


def nearest_neighbors_legacy(
    x: np.ndarray, block: int = 1024, *, device: str | torch.device = "cuda"
) -> np.ndarray:
    """The host loop: one (block, m) distance tile per step, each brought
    back to the host before the next. Kept as the parity oracle."""
    device = resolve_device(device)
    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
    out = []
    for a in range(0, xt.shape[0], block):
        out.append(_nn_block(xt[a : a + block], xt, a).cpu().numpy())
    return np.concatenate(out).astype(np.int32)


def nearest_neighbors(
    x: np.ndarray, *, device: str | torch.device = "cuda"
) -> np.ndarray:
    """Index of the nearest other point for every row — one pairwise scan."""
    from repro_torch.analytics.pairwise import pairwise_knn

    idx, _ = pairwise_knn(x, device=device)
    return idx


def knn_retrieval_accuracy(
    x: np.ndarray,
    labels: np.ndarray,
    *,
    device: str | torch.device = "cuda",
) -> float:
    """Label agreement rate of 1-NN retrieval (paper Table 2/4 metric)."""
    nn = nearest_neighbors(x, device=device)
    return float((labels[nn] == labels).mean())
