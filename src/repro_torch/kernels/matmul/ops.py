"""Dispatcher for the K1 matrix product (``csrc/matmul.cu``).

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
on the current stream or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul.ref import matmul_ref

LAUNCHES = 0  # kernel launches in this process (plain-version calls excluded)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 3
    + [ctypes.c_longlong] * 4
    + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)
_TILE = 64  # output tile edge of the kernel
_MIN_K_PER_SPLIT = 256


def _splits(m: int, n: int, k: int, device: torch.device) -> int:
    """K splits that give at least two blocks per SM when the output has
    too few tiles to fill the card on its own."""
    tiles = -(-m // _TILE) * -(-n // _TILE)
    target = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    if tiles >= target:
        return 1
    return max(1, min(-(-target // tiles), k // _MIN_K_PER_SPLIT, 64))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B for 2-D float32 or bfloat16 operands of one dtype, any
    strides (a transposed view is read in place); float32 accumulation,
    output in A's dtype."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"matmul: operands on {a.device} and {b.device}; both must be on "
            "the CPU or on one CUDA device"
        )
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(
            f"matmul: dtypes {a.dtype}, {b.dtype}; need one of float32/bfloat16"
        )
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k, a.numel(), b.numel(), m * n) >= 2**31:
        raise ValueError("matmul: sizes must stay below 2**31 elements")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    splits = _splits(m, n, k, a.device)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=a.device) if splits > 1 else None
    fn = _build.function("matmul", "repro_matmul", _ARGTYPES)
    err = fn(
        _build.ptr(a), _build.ptr(b), _build.ptr(out),
        _build.ptr(ws) if ws is not None else None,
        m, n, k, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
        splits, _DTYPES[a.dtype], _build.stream_ptr(a.device),
    )
    _build.check("matmul", "repro_matmul", err)
    global LAUNCHES
    LAUNCHES += 1
    return out
