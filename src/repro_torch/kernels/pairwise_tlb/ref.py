"""Plain PyTorch version of the K2 all-prefix pairwise-TLB table."""

import torch


def pairwise_tlb_ref(
    xi: torch.Tensor, xj: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """(P, d), (P, d), (d, K) -> (P, K) per-pair TLB at every prefix k."""
    diffs = (xi - xj).float()
    denom2 = torch.sum(diffs * diffs, dim=-1, keepdim=True)
    z = torch.matmul(diffs, v.float())
    cum = torch.cumsum(z * z, dim=-1)
    tlb = torch.sqrt(torch.clamp(cum / torch.clamp_min(denom2, 1e-30), 0.0, 1.0))
    # coincident pairs have zero distance in every basis: TLB contribution 1
    return torch.where(denom2 > 1e-30, tlb, torch.ones_like(tlb))
