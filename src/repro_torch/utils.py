"""Shared small utilities: the paper's clock and device resolution."""

from __future__ import annotations

import time

import torch


class Clock:
    """Wall-clock timer matching the paper's CLOCK.RESTART / CLOCK.ELAPSED."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def restart(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on. A CUDA device that is not there
    raises: the port never carries on on the CPU unless asked to.

    On a CUDA device the TF32 modes are switched off, so every
    ``torch.linalg`` call and plain matrix product computes in IEEE float32,
    as the JAX package does at ``Precision.HIGHEST``."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device


def synchronize(device: torch.device) -> None:
    """Wait for all work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
