"""Dispatcher for the K3 1-NN reduction (``csrc/pairwise_knn.cu``).

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
on the current stream or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_reduce.ref import pairwise_knn_ref

LAUNCHES = 0  # kernel launches in this process (plain-version calls excluded)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def pairwise_knn_reduce(xq: torch.Tensor, x: torch.Tensor, m: int):
    """(mq, d) queries — the first mq rows of the dataset — and the (mk, d)
    dataset, float32 -> (nearest other row int32 (mq,), squared distance
    float32 (mq,)). Columns >= m are excluded."""
    if xq.device.type == "cpu" and x.device.type == "cpu":
        return pairwise_knn_ref(xq, x, m)
    if xq.device.type != "cuda" or x.device != xq.device:
        raise ValueError(
            f"pairwise_knn_reduce: inputs on {xq.device} and {x.device}; both "
            "must be on the CPU or on one CUDA device"
        )
    if xq.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("pairwise_knn_reduce: the kernel takes float32 inputs")
    if not (xq.is_contiguous() and x.is_contiguous()):
        raise ValueError("pairwise_knn_reduce: inputs must be contiguous")
    if xq.dim() != 2 or x.dim() != 2 or xq.shape[1] != x.shape[1]:
        raise ValueError(
            f"pairwise_knn_reduce: bad shapes {tuple(xq.shape)}, {tuple(x.shape)}"
        )
    if not 0 <= m <= x.shape[0]:
        raise ValueError(f"pairwise_knn_reduce: m={m} outside [0, {x.shape[0]}]")
    if max(xq.numel(), x.numel()) >= 2**31:
        raise ValueError("pairwise_knn_reduce: sizes must stay below 2**31 elements")
    mq, d = xq.shape
    idx = torch.empty((mq,), dtype=torch.int32, device=xq.device)
    d2 = torch.empty((mq,), dtype=torch.float32, device=xq.device)
    if mq == 0:
        return idx, d2
    fn = _build.function("pairwise_knn", "repro_pairwise_knn", _ARGTYPES)
    err = fn(
        _build.ptr(xq), _build.ptr(x), _build.ptr(idx), _build.ptr(d2),
        mq, x.shape[0], d, m, _build.stream_ptr(xq.device),
    )
    _build.check("pairwise_knn", "repro_pairwise_knn", err)
    global LAUNCHES
    LAUNCHES += 1
    return idx, d2
