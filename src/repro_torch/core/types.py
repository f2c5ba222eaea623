"""Core dataclasses for the DROP optimizer (paper Table 1 notation)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Literal, Sequence

import numpy as np

# Default progressive sampling schedule from §4.1 of the paper: ten steps,
# data processed no more than ~2.4x in total.
DEFAULT_SCHEDULE: tuple[float, ...] = (
    0.01, 0.02, 0.03, 0.04, 0.05, 0.10, 0.20, 0.30, 0.65, 1.00,
)


@dataclass(frozen=True)
class DropConfig:
    """Inputs of Problem 3.1 plus implementation knobs.

    Attributes:
        target_tlb: B — TLB preservation level (paper default 0.98).
        confidence: c — confidence for the sampled TLB estimate (default 0.95).
        schedule: progressive sampling schedule (fractions of m).
        reuse_fraction: q/100 — bottom-percentile of points carried into the
            next sample (importance sampling / work reuse; paper default 0.10).
        svd: "halko" (paper's randomized PCA) or "full" (exact SVD).
        halko_oversample: p in Algorithm 3 (default 5).
        halko_power_iters: q in Algorithm 3 (default 1).
        search: "binary" (paper Algorithm 4) or "prefix" (all-prefix TLB
            search — one fused pass instead of O(log d) evaluations).
        initial_pairs: starting pair count for the TLB CI loop (paper: 100).
        max_pairs: cap on TLB evaluation pairs (paper observes <=300 typical).
        min_iterations: run at least this many iterations before the progress
            estimator may terminate (needs 2 points for a slope).
        seed: determinism.

    There is no kernel switch: the device the caller names decides whether
    the hand-written CUDA kernels run (a CUDA device) or their plain
    PyTorch versions (the CPU).
    """

    target_tlb: float = 0.98
    confidence: float = 0.95
    schedule: Sequence[float] = DEFAULT_SCHEDULE
    reuse_fraction: float = 0.10
    svd: Literal["halko", "full"] = "halko"
    halko_oversample: int = 5
    halko_power_iters: int = 1
    search: Literal["binary", "prefix"] = "binary"
    initial_pairs: int = 100
    # the paper observes <=300 pairs suffice; the cap only binds when the CI
    # straddles the target at the boundary k (where more pairs cannot change
    # the decision materially but cost O(pairs x d x k) each)
    max_pairs: int = 800
    min_iterations: int = 2
    seed: int = 0


@dataclass
class IterationRecord:
    """Per-iteration telemetry (i, m_i, k_i, r_i, obj_i)."""

    i: int
    sample_size: int
    k: int
    tlb_estimate: float
    runtime_s: float
    objective: float
    satisfied: bool
    pairs_used: int


@dataclass
class ReduceResult:
    """The paper's T_k as an explicit linear map.

    ``v`` is the (d, k) operator matrix and ``mean`` the centering offset,
    both numpy arrays wherever the map was fitted, so a result compares
    directly with the JAX package's and moves between the two packages
    (``repro_torch.interop``).
    """

    v: np.ndarray  # (d, k) linear operator (PCA: basis columns)
    mean: np.ndarray  # (d,) centering offset (zeros for uncentered methods)
    k: int
    tlb_estimate: float
    satisfied: bool
    runtime_s: float
    iterations: list[IterationRecord] = field(default_factory=list)
    method: str = "pca"

    def transform(self, y: np.ndarray) -> np.ndarray:
        """Apply the learned transformation (Algorithm 1 TRANSFORM).

        Inputs are cast through float32 first: the map was fit in float32,
        and a float64 caller must see bit-identical outputs to a float32
        caller.
        """
        y32 = np.asarray(y, dtype=np.float32)
        return (y32 - np.asarray(self.mean, dtype=np.float32)) @ np.asarray(
            self.v, dtype=np.float32
        )

    @property
    def total_rows_processed(self) -> int:
        return sum(rec.sample_size for rec in self.iterations)


CostFn = Callable[[int], float]
