"""Pairwise reductions for the downstream analytics.

kNN retrieval (and, in a later slice of the port, DBSCAN radius queries and
Gaussian KDE) is a row-reduction over the (m, m) pairwise squared-distance
matrix. On a CUDA device the whole scan is one launch of kernel K3, which
carries the running (min d², argmin) per row across dataset tiles, so the
m x m matrix never exists; on the CPU the plain version materializes it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.pairwise_reduce import ops as knn_ops
from repro_torch.utils import resolve_device


def pairwise_knn(
    x: np.ndarray, *, device: str | torch.device = "cuda"
) -> tuple[np.ndarray, np.ndarray]:
    """Nearest OTHER row per row of ``x``: (indices int32, squared dists).

    Ties keep the first occurrence (lowest index); a single row returns
    itself (index 0) at distance +inf."""
    device = resolve_device(device)
    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
    idx, d2 = knn_ops.pairwise_knn_reduce(xt, xt, xt.shape[0])
    return idx.cpu().numpy(), d2.cpu().numpy()
