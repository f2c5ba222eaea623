"""DBSCAN (Ester et al. 1996) — the paper's second end-to-end task (§4.4).

The device side is one pairwise scan (``analytics.pairwise``; kernel K4 on
a CUDA device): eps-ball degree counts + packed uint32 neighbor bitmasks in
one launch and one device->host copy. The host BFS consumes the packed
bits — core checks read the degrees, and a row is only decoded when the
expansion visits it. The BFS and the decoder are host numpy, as in the JAX
package: at a dense eps, DBSCAN's time is host time.

``dbscan_legacy`` keeps the blocked host loop as the parity oracle. Both
paths share ``_bfs``, so their labels agree exactly (identical traversal
order — DBSCAN border-point labels are traversal-order dependent).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.utils import resolve_device

NOISE = -1
UNVISITED = -2


def _neighbor_lists(
    x: np.ndarray, eps: float, block: int, device: torch.device
) -> list[np.ndarray]:
    """Per-row eps-neighbors (self excluded), one (block, m) radius tile on
    the device per step, brought back to the host before the next."""
    xs = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
    eps2 = torch.tensor(float(eps) * float(eps), dtype=torch.float32)
    sq_x = torch.sum(xs * xs, dim=1)
    out: list[np.ndarray] = []
    for a in range(0, xs.shape[0], block):
        xq = xs[a : a + block]
        sq_q = torch.sum(xq * xq, dim=1, keepdim=True)
        d2 = sq_q + sq_x[None, :] - 2.0 * xq @ xs.T
        mask = (d2 <= eps2).cpu().numpy()
        for r in range(xq.shape[0]):
            nbrs = np.nonzero(mask[r])[0]
            out.append(nbrs[nbrs != a + r])
    return out


def _bfs(
    m: int,
    min_samples: int,
    degrees: np.ndarray,
    neighbors: Callable[[int], np.ndarray],
) -> np.ndarray:
    """The (host) expansion shared by the fused and legacy paths.

    ``degrees`` INCLUDE the self point (a point is always within eps of
    itself); ``neighbors(p)`` returns p's eps-neighbors sorted ascending,
    self excluded, so the traversal (and with it every border-point label)
    is the same on both paths."""
    labels = np.full(m, UNVISITED, dtype=np.int64)
    cluster = 0
    for p in range(m):
        if labels[p] != UNVISITED:
            continue
        if degrees[p] < min_samples:
            labels[p] = NOISE
            continue
        labels[p] = cluster
        frontier = list(neighbors(p))
        while frontier:
            q = frontier.pop()
            if labels[q] == NOISE:
                labels[q] = cluster
            if labels[q] != UNVISITED:
                continue
            labels[q] = cluster
            if degrees[q] >= min_samples:
                frontier.extend(neighbors(q))
        cluster += 1
    return labels


def dbscan(
    x: np.ndarray,
    eps: float = 0.5,
    min_samples: int = 5,
    *,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Cluster labels per point; -1 = noise. One pairwise scan on
    ``device``, then the host BFS."""
    from repro_torch.analytics.pairwise import NeighborDecoder, pairwise_dbscan

    m = x.shape[0]
    counts, packed = pairwise_dbscan(x, eps, device=device)
    return _bfs(m, min_samples, counts, NeighborDecoder(packed, m))


def dbscan_legacy(
    x: np.ndarray,
    eps: float = 0.5,
    min_samples: int = 5,
    block: int = 1024,
    *,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """The blocked path: radius queries with a host copy per block and a
    per-row ``np.nonzero``. Parity oracle."""
    device = resolve_device(device)
    m = x.shape[0]
    nbrs = _neighbor_lists(x, eps, block, device)
    degrees = np.array([n.size + 1 for n in nbrs])
    return _bfs(m, min_samples, degrees, lambda p: nbrs[p])
