"""Plain PyTorch versions of the pairwise reductions K3 (1-NN), K4 (DBSCAN
eps-ball) and K5 (Gaussian KDE).

Deliberately unfused: each materializes the full (mq, mk) distance matrix
and reduces it in one shot, the simplest statement of the semantics.
"""

import torch


def _full_d2(xq: torch.Tensor, x: torch.Tensor, m: int) -> torch.Tensor:
    """(mq, mk) squared distances by the expansion ||q||^2 + ||x||^2 - 2 q.x;
    columns >= m are +inf."""
    xq = xq.float()
    x = x.float()
    sq_q = torch.sum(xq * xq, dim=1, keepdim=True)
    sq_x = torch.sum(x * x, dim=1)
    d2 = sq_q + sq_x[None, :] - 2.0 * torch.matmul(xq, x.T)
    cols = torch.arange(x.shape[0], device=x.device)
    return torch.where(cols[None, :] >= m, torch.inf, d2)


def pairwise_knn_ref(xq: torch.Tensor, x: torch.Tensor, m: int):
    """(mq, d) queries (the first mq rows of x), (mk, d) dataset ->
    (nearest other row int32 (mq,), its squared distance (mq,)).
    Columns >= m count as +inf; ties keep the first occurrence."""
    d2 = _full_d2(xq, x, m)
    rows = torch.arange(xq.shape[0], device=x.device)
    cols = torch.arange(x.shape[0], device=x.device)
    d2 = torch.where(rows[:, None] == cols[None, :], torch.inf, d2)
    idx = torch.argmin(d2, dim=1)  # first occurrence on ties
    return idx.to(torch.int32), torch.gather(d2, 1, idx[:, None])[:, 0]


def pack_bits_u32(mask: torch.Tensor) -> torch.Tensor:
    """(rows, cols) bool -> (rows, ceil(cols/32)) uint32, little-endian: bit j
    of word w flags column 32w + j; the tail bits past ``cols`` are 0."""
    rows, cols = mask.shape
    w = -(-cols // 32)
    bits = torch.zeros((rows, w * 32), dtype=torch.int64, device=mask.device)
    bits[:, :cols] = mask.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    words = torch.sum(bits.reshape(rows, w, 32) << shifts, dim=2)
    # uint32 has few torch operators: wrap to int32 and reinterpret the bits
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).view(torch.uint32)


def pairwise_dbscan_ref(xq: torch.Tensor, x: torch.Tensor, m: int, eps2: float):
    """(mq, d) queries, (mk, d) dataset -> (eps-ball counts int32 (mq,),
    packed neighbor bits uint32 (mq, ceil(mk/32))). A column is a neighbor
    when its d2 <= eps2 (in float32); self is included, columns >= m are
    not."""
    mask = _full_d2(xq, x, m) <= torch.tensor(eps2, dtype=torch.float32)
    counts = torch.sum(mask, dim=1, dtype=torch.int32)
    return counts, pack_bits_u32(mask)


def pairwise_kde_ref(xq: torch.Tensor, x: torch.Tensor, m: int, inv_two_h2: float):
    """(mq, d) queries, (mk, d) dataset -> (sums float32 (mq,), comps (mq,)):
    sums of exp(-max(d2, 0) * inv_two_h2) over the columns < m. ``comps``
    is zero (a one-shot sum carries no compensation); it is returned so the
    kernel and the plain version have one signature."""
    d2 = _full_d2(xq, x, m)
    inv = torch.tensor(inv_two_h2, dtype=torch.float32)
    e = torch.where(
        torch.isfinite(d2), torch.exp(-torch.clamp(d2, min=0.0) * inv), 0.0
    )
    sums = torch.sum(e, dim=1)
    return sums, torch.zeros_like(sums)
