"""Plain PyTorch version of the K1 matrix product."""

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B accumulated in float32, returned in A's dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)
