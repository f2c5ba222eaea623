"""Plain PyTorch version of the K3 1-NN reduction.

Deliberately unfused: it materializes the full (mq, mk) distance matrix and
reduces it in one shot, the simplest statement of the semantics.
"""

import torch


def pairwise_knn_ref(xq: torch.Tensor, x: torch.Tensor, m: int):
    """(mq, d) queries (the first mq rows of x), (mk, d) dataset ->
    (nearest other row int32 (mq,), its squared distance (mq,)).
    Columns >= m count as +inf; ties keep the first occurrence."""
    xq = xq.float()
    x = x.float()
    sq_q = torch.sum(xq * xq, dim=1, keepdim=True)
    sq_x = torch.sum(x * x, dim=1)
    d2 = sq_q + sq_x[None, :] - 2.0 * torch.matmul(xq, x.T)
    rows = torch.arange(xq.shape[0], device=x.device)
    cols = torch.arange(x.shape[0], device=x.device)
    excluded = (cols[None, :] >= m) | (rows[:, None] == cols[None, :])
    d2 = torch.where(excluded, torch.inf, d2)
    idx = torch.argmin(d2, dim=1)  # first occurrence on ties
    return idx.to(torch.int32), torch.gather(d2, 1, idx[:, None])[:, 0]
