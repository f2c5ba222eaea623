"""Dispatcher for the K2 all-prefix pairwise-TLB table
(``csrc/pairwise_tlb.cu``).

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
on the current stream or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_tlb.ref import pairwise_tlb_ref

LAUNCHES = 0  # kernel launches in this process (plain-version calls excluded)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def pairwise_tlb(
    xi: torch.Tensor, xj: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """(P, d), (P, d), (d, K) float32 -> (P, K) all-prefix TLB table."""
    tensors = (xi, xj, v)
    if all(t.device.type == "cpu" for t in tensors):
        return pairwise_tlb_ref(xi, xj, v)
    if xi.device.type != "cuda" or any(t.device != xi.device for t in tensors):
        raise ValueError(
            "pairwise_tlb: xi, xj and v must all be on the CPU or on one CUDA "
            f"device, got {[str(t.device) for t in tensors]}"
        )
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("pairwise_tlb: the kernel takes float32 inputs")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("pairwise_tlb: inputs must be contiguous")
    if xi.dim() != 2 or xj.shape != xi.shape or v.dim() != 2 or v.shape[0] != xi.shape[1]:
        raise ValueError(
            f"pairwise_tlb: bad shapes {tuple(xi.shape)}, {tuple(xj.shape)}, "
            f"{tuple(v.shape)}"
        )
    p, d = xi.shape
    k = v.shape[1]
    if max(xi.numel(), v.numel(), p * k) >= 2**31:
        raise ValueError("pairwise_tlb: sizes must stay below 2**31 elements")
    out = torch.empty((p, k), dtype=torch.float32, device=xi.device)
    if p == 0 or k == 0:
        return out
    fn = _build.function("pairwise_tlb", "repro_pairwise_tlb", _ARGTYPES)
    err = fn(
        _build.ptr(xi), _build.ptr(xj), _build.ptr(v), _build.ptr(out),
        p, d, k, _build.stream_ptr(xi.device),
    )
    _build.check("pairwise_tlb", "repro_pairwise_tlb", err)
    global LAUNCHES
    LAUNCHES += 1
    return out
