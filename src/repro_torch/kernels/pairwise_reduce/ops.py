"""Dispatchers for the pairwise reductions K3 1-NN (``csrc/pairwise_knn.cu``),
K4 DBSCAN eps-ball (``csrc/pairwise_dbscan.cu``) and K5 Gaussian KDE
(``csrc/pairwise_kde.cu``).

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
on the current stream or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_reduce.ref import (
    pairwise_dbscan_ref,
    pairwise_kde_ref,
    pairwise_knn_ref,
)

# kernel launches in this process, per kernel (plain-version calls excluded)
LAUNCHES = {"pairwise_knn": 0, "pairwise_dbscan": 0, "pairwise_kde": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _on_cpu(name: str, xq: torch.Tensor, x: torch.Tensor, m: int) -> bool:
    """True for two CPU tensors (the plain version runs); checks what the
    kernel takes for CUDA tensors and raises on anything else."""
    if xq.device.type == "cpu" and x.device.type == "cpu":
        return True
    if xq.device.type != "cuda" or x.device != xq.device:
        raise ValueError(
            f"{name}: inputs on {xq.device} and {x.device}; both must be on "
            "the CPU or on one CUDA device"
        )
    if xq.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32 inputs")
    if not (xq.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if xq.dim() != 2 or x.dim() != 2 or xq.shape[1] != x.shape[1]:
        raise ValueError(f"{name}: bad shapes {tuple(xq.shape)}, {tuple(x.shape)}")
    if not 0 <= m <= x.shape[0]:
        raise ValueError(f"{name}: m={m} outside [0, {x.shape[0]}]")
    if max(xq.numel(), x.numel()) >= 2**31:
        raise ValueError(f"{name}: sizes must stay below 2**31 elements")
    return False


def pairwise_knn_reduce(xq: torch.Tensor, x: torch.Tensor, m: int):
    """(mq, d) queries — the first mq rows of the dataset — and the (mk, d)
    dataset, float32 -> (nearest other row int32 (mq,), squared distance
    float32 (mq,)). Columns >= m are excluded."""
    if _on_cpu("pairwise_knn_reduce", xq, x, m):
        return pairwise_knn_ref(xq, x, m)
    mq, d = xq.shape
    idx = torch.empty((mq,), dtype=torch.int32, device=xq.device)
    d2 = torch.empty((mq,), dtype=torch.float32, device=xq.device)
    if mq == 0:
        return idx, d2
    fn = _build.function("pairwise_knn", "repro_pairwise_knn", [_P] * 4 + [_I] * 4 + [_P])
    err = fn(
        _build.ptr(xq), _build.ptr(x), _build.ptr(idx), _build.ptr(d2),
        mq, x.shape[0], d, m, _build.stream_ptr(xq.device),
    )
    _build.check("pairwise_knn", "repro_pairwise_knn", err)
    LAUNCHES["pairwise_knn"] += 1
    return idx, d2


def pairwise_dbscan_reduce(xq: torch.Tensor, x: torch.Tensor, m: int, eps2: float):
    """(mq, d) queries and the (mk, d) dataset, float32 -> (eps-ball counts
    int32 (mq,), packed neighbor bits uint32 (mq, ceil(mk/32))): bit j of
    word w flags column 32w + j with d2 <= eps2. Self is included, columns
    >= m are not; ``eps2`` is compared in float32."""
    if _on_cpu("pairwise_dbscan_reduce", xq, x, m):
        return pairwise_dbscan_ref(xq, x, m, eps2)
    mq, d = xq.shape
    mk = x.shape[0]
    counts = torch.zeros((mq,), dtype=torch.int32, device=xq.device)
    packed = torch.empty((mq, -(-mk // 32)), dtype=torch.uint32, device=xq.device)
    if mq == 0:
        return counts, packed
    fn = _build.function(
        "pairwise_dbscan", "repro_pairwise_dbscan", [_P] * 4 + [_I] * 4 + [_F, _P]
    )
    err = fn(
        _build.ptr(xq), _build.ptr(x), _build.ptr(counts), _build.ptr(packed),
        mq, mk, d, m, float(eps2), _build.stream_ptr(xq.device),
    )
    _build.check("pairwise_dbscan", "repro_pairwise_dbscan", err)
    LAUNCHES["pairwise_dbscan"] += 1
    return counts, packed


def pairwise_kde_reduce(xq: torch.Tensor, x: torch.Tensor, m: int, inv_two_h2: float):
    """(mq, d) queries and the (mk, d) dataset, float32 -> a compensated
    pair (sums, comps) float32 (mq,) of sum over columns < m of
    exp(-max(d2, 0) * inv_two_h2); the value is sums + comps, to be folded
    in float64 (``analytics.pairwise.kde_from_compensated``)."""
    if _on_cpu("pairwise_kde_reduce", xq, x, m):
        return pairwise_kde_ref(xq, x, m, inv_two_h2)
    mq, d = xq.shape
    mk = x.shape[0]
    sums = torch.empty((mq,), dtype=torch.float32, device=xq.device)
    comps = torch.empty((mq,), dtype=torch.float32, device=xq.device)
    if mq == 0:
        return sums, comps
    splits = _build.function("pairwise_kde", "repro_pairwise_kde_splits", [_I] * 3)(mq, mk, m)
    scratch = torch.empty((2, splits, mq) if splits > 1 else (0,), dtype=torch.float32,
                          device=xq.device)
    fn = _build.function("pairwise_kde", "repro_pairwise_kde", [_P] * 5 + [_I] * 4 + [_F, _I, _P])
    err = fn(
        _build.ptr(xq), _build.ptr(x), _build.ptr(sums), _build.ptr(comps), _build.ptr(scratch),
        mq, mk, d, m, float(inv_two_h2), splits, _build.stream_ptr(xq.device),
    )
    _build.check("pairwise_kde", "repro_pairwise_kde", err)
    LAUNCHES["pairwise_kde"] += 1
    return sums, comps
