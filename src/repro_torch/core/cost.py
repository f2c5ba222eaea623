"""Downstream cost functions C_m(k) (paper §3.1, §3.5).

C_m maps output dimensionality k to *estimated downstream runtime in seconds*,
so it is directly commensurable with DROP's own runtime R in the objective
R + C_m(k). The paper's default models k-NN: O(m^2 k).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np


@dataclass(frozen=True)
class CostModel:
    name: str
    fn: Callable[[int], float]

    def __call__(self, k: int) -> float:
        return float(self.fn(max(int(k), 0)))


# The JAX package's coefficients, calibrated on a CPU host with its numpy and
# XLA:CPU kNN: seconds per (m^2 * k) element-op, and the k-independent seconds
# per m^2 pair of the fused pairwise scan. They are kept so that a cost model
# prices the same k identically in both packages; `calibrate_pairwise_intercept`
# re-measures the second on the port's own kNN.
DEFAULT_KNN_COEFF = 2.5e-10
DEFAULT_KNN_MEM_COEFF = 8.0e-9
DEFAULT_LINEAR_COEFF = 1.0e-8


def knn_cost(
    m: int,
    coeff: float = DEFAULT_KNN_COEFF,
    mem_coeff: float = DEFAULT_KNN_MEM_COEFF,
) -> CostModel:
    """k-NN / DBSCAN-style all-pairs downstream:
    C(k) = coeff * m^2 * k + mem_coeff * m^2 (paper model + measured
    k-independent memory term; pass ``mem_coeff=0`` for the pure paper
    model)."""
    return CostModel(
        "knn",
        lambda k: coeff * float(m) * float(m) * k
        + mem_coeff * float(m) * float(m),
    )


def linear_cost(m: int, coeff: float = DEFAULT_LINEAR_COEFF) -> CostModel:
    """Similarity-search-style downstream linear in dimension: C(k) = c*m*k."""
    return CostModel("linear", lambda k: coeff * float(m) * k)


def zero_cost() -> CostModel:
    """Pure-quality mode: never pays for dimension, so DROP runs the whole
    schedule and returns its best basis (oracle-quality reference)."""
    return CostModel("zero", lambda k: 0.0)


# the paper's three end-to-end analytics are all all-pairs distance tasks:
# k-NN retrieval, DBSCAN radius queries, and Gaussian KDE each do O(m^2 k)
# distance work on the reduced data, so they share the quadratic model
DOWNSTREAM_COSTS = ("knn", "dbscan", "kde")


def downstream_cost(
    name: str,
    m: int,
    coeff: float = DEFAULT_KNN_COEFF,
    mem_coeff: float = DEFAULT_KNN_MEM_COEFF,
    legacy_cost: bool = False,
) -> CostModel:
    """Price a named downstream task as a C_m(k) model:
    ``coeff*m^2*k + mem_coeff*m^2``, the paper's O(m^2 k) distance work plus
    the k-independent O(m^2) term of a fused pairwise scan.
    ``legacy_cost=True`` restores the pure O(m^2 k) paper model."""
    if name not in DOWNSTREAM_COSTS:
        raise KeyError(
            f"unknown downstream {name!r}; know {DOWNSTREAM_COSTS}"
        )
    if legacy_cost:
        mem_coeff = 0.0
    return CostModel(name, knn_cost(m, coeff, mem_coeff).fn)


def calibrate_pairwise_intercept(
    m_probe: int = 4000,
    d_probe: int = 3,
    iters: int = 3,
    *,
    device: str = "cuda",
) -> float:
    """Measure the k-independent seconds-per-m^2 intercept of the port's kNN
    on ``device``: at a tiny d the O(m^2 k) term is negligible, so best-of-N
    warm wall clock over m^2 IS the memory term."""
    from repro_torch.analytics.knn import nearest_neighbors

    x = np.random.default_rng(0).normal(size=(m_probe, d_probe))
    x = x.astype(np.float32)
    nearest_neighbors(x, device=device)  # first call builds the kernel
    nearest_neighbors(x, device=device)
    best = float("inf")
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        nearest_neighbors(x, device=device)
        best = min(best, time.perf_counter() - t0)
    return max(best / (m_probe * m_probe) - DEFAULT_KNN_COEFF * d_probe, 0.0)
