"""Reducer protocol — the method-agnostic face of the DROP optimizer.

The paper's thesis is that dimensionality reduction should be *optimized
end-to-end* against the downstream workload, not hard-wired to one
factorization. Every DR operator in the comparison (PCA, FFT, PAA, DWT, JL)
is a ``Reducer`` — a resumable, steppable runner:

* ``step() -> bool`` — run one unit of work; True while more remains.
  ``PcaDropReducer`` (the Algorithm-2 loop) takes many data-dependent steps;
  the deterministic baselines are one-step reducers.
* ``result() -> ReduceResult`` — the fitted (d, k) linear map plus TLB
  telemetry. Every method here IS a linear map, so one result type serves
  them all.
* ``update(suffix)`` — the incremental path; no reducer of the port has it
  yet (``supports_update`` is False), so each raises.

The baselines run on the host in numpy, as in the JAX package; only
``PcaDropReducer`` takes a device. ``make_reducer`` builds the reducer for
a method name; ``reduce`` drives any method to completion (the
generalization of ``drop()``).
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.drop import PcaDropReducer
from repro_torch.core.types import CostFn, DropConfig, IterationRecord, ReduceResult
from repro_torch.utils import Clock


@runtime_checkable
class Reducer(Protocol):
    """What the optimizer needs from a DR operator (see module docstring)."""

    method: str
    done: bool
    records: list
    cacheable: bool  # may the result be reused for a repeat query?
    supports_update: bool  # does update(suffix) avoid a refit?

    def step(self) -> bool: ...

    def result(self) -> ReduceResult: ...

    def update(self, suffix: np.ndarray) -> ReduceResult: ...


def method_operator(method: str, d: int, k: int, seed: int = 0) -> np.ndarray:
    """Materialize a baseline's (d, k) operator by applying it to the
    identity. Exact because every method is linear — and it is what lets
    FFT/PAA/DWT/JL results be applied like a PCA basis."""
    eye = np.eye(d, dtype=np.float32)
    if method == "fft":
        from repro_torch.baselines.fft import fft_real_expansion

        return fft_real_expansion(eye)[:, :k]
    if method == "dwt":
        from repro_torch.baselines.dwt import haar_expansion

        return haar_expansion(eye)[:, :k]
    if method == "paa":
        from repro_torch.baselines.paa import paa_transform

        return paa_transform(eye, k)
    if method == "jl":
        from repro_torch.baselines.jl import jl_operator

        return jl_operator(d, k, seed)
    raise KeyError(f"no materialized operator for method {method!r}")


class SingleShotReducer:
    """Base for the one-step baseline reducers.

    The whole computation (expansion + min-k search + operator
    materialization) happens in the single ``step()``, host numpy as in
    the JAX package. The min-k search reuses the shared TLB machinery
    (``core.tlb.nested_min_k`` / ``transform_min_k``) on the pair sample
    drawn from ``cfg.seed``, ``cfg.max_pairs`` pairs.
    """

    method = ""
    cacheable = True
    supports_update = False  # one-shot fits keep refit semantics

    def __init__(
        self,
        x: np.ndarray,
        cfg: DropConfig | None = None,
        cost: CostFn | None = None,
    ) -> None:
        self.cfg = cfg or DropConfig()
        if cost is None:
            from repro_torch.core.cost import knn_cost

            cost = knn_cost(x.shape[0])
        self.cost = cost
        self.x = np.ascontiguousarray(x, dtype=np.float32)
        self.records: list[IterationRecord] = []
        self.done = False
        self._result: ReduceResult | None = None
        self._clock = Clock()

    def _sample(self) -> np.ndarray:
        from repro_torch.core.tlb import sample_pairs

        rng = np.random.default_rng(self.cfg.seed)
        return sample_pairs(self.x.shape[0], self.cfg.max_pairs, rng)

    def _solve(self) -> tuple[int, float, bool, int]:
        """(k, tlb_mean_at_k, satisfied, pairs_used) — method-specific."""
        raise NotImplementedError

    def step(self) -> bool:
        """The one step: search min-k and materialize the operator."""
        if self.done:
            return False
        self._clock.restart()
        k, tlb_mean, satisfied, pairs = self._solve()
        v = method_operator(self.method, self.x.shape[1], k, self.cfg.seed)
        r_i = self._clock.elapsed()
        self.records.append(
            IterationRecord(
                i=0,
                sample_size=self.x.shape[0],
                k=k,
                tlb_estimate=tlb_mean,
                runtime_s=r_i,
                objective=r_i + self.cost(k),
                satisfied=satisfied,
                pairs_used=pairs,
            )
        )
        self._result = ReduceResult(
            v=v,
            mean=np.zeros(self.x.shape[1], np.float32),
            k=k,
            tlb_estimate=tlb_mean,
            satisfied=satisfied,
            runtime_s=r_i,
            iterations=self.records,
            method=self.method,
        )
        self.done = True
        return False

    def result(self) -> ReduceResult:
        if self._result is None:
            raise RuntimeError("result() before any step()")
        return self._result

    def update(self, suffix: np.ndarray) -> ReduceResult:
        """Single-shot methods keep refit semantics: their whole fit is one
        cheap step, so an incremental path has nothing to amortize."""
        raise NotImplementedError(
            f"{type(self).__name__} keeps refit semantics: appended rows "
            "require a fresh fit (supports_update=False)"
        )


class FftReducer(SingleShotReducer):
    """Fourier prefix reducer (nested: one expansion answers every k)."""

    method = "fft"

    def _solve(self) -> tuple[int, float, bool, int]:
        from repro_torch.baselines.fft import fft_real_expansion
        from repro_torch.core.tlb import nested_min_k

        pairs = self._sample()
        k, tlb_k = nested_min_k(
            self.x, fft_real_expansion(self.x), self.cfg.target_tlb, pairs
        )
        tlb = float(tlb_k[k - 1])
        return k, tlb, tlb >= self.cfg.target_tlb, pairs.shape[0]


class DwtReducer(SingleShotReducer):
    """Haar wavelet prefix reducer (nested, coarse-to-fine; k may exceed d
    when the pow2-padded expansion is wider than the input)."""

    method = "dwt"

    def _solve(self) -> tuple[int, float, bool, int]:
        from repro_torch.baselines.dwt import haar_expansion
        from repro_torch.core.tlb import nested_min_k

        pairs = self._sample()
        k, tlb_k = nested_min_k(
            self.x, haar_expansion(self.x), self.cfg.target_tlb, pairs
        )
        tlb = float(tlb_k[k - 1])
        return k, tlb, tlb >= self.cfg.target_tlb, pairs.shape[0]


class PaaReducer(SingleShotReducer):
    """PAA segment-count reducer (non-nested: binary search over k)."""

    method = "paa"

    def _solve(self) -> tuple[int, float, bool, int]:
        from repro_torch.baselines.paa import paa_transform
        from repro_torch.core.tlb import transform_min_k, transform_tlb_sampled

        pairs = self._sample()
        k = transform_min_k(
            self.x, paa_transform, self.cfg.target_tlb, pairs, self.x.shape[1]
        )
        mean, _, _ = transform_tlb_sampled(
            self.x, paa_transform(self.x, k), pairs
        )
        return k, float(mean), mean >= self.cfg.target_tlb, pairs.shape[0]


class JlReducer(SingleShotReducer):
    """JL random-projection reducer (data-independent). The mean distance
    ratio E[chi_k / sqrt(k)] ~= 1 - 1/(4k) grows toward 1 with k, so the
    binary search of PAA applies; each probe redraws the operator for its
    k. Not contractive — ``satisfied`` means the mean ratio reached the
    target, not a lower bound.

    Not cacheable: the operator is fully derived from (d, k, seed), so there
    is no fitting to amortize."""

    method = "jl"
    cacheable = False

    def _solve(self) -> tuple[int, float, bool, int]:
        from repro_torch.baselines.jl import jl_transform
        from repro_torch.core.tlb import transform_min_k, transform_tlb_sampled

        pairs = self._sample()
        seed = self.cfg.seed
        k = transform_min_k(
            self.x,
            lambda a, kk: jl_transform(a, kk, seed),
            self.cfg.target_tlb,
            pairs,
            self.x.shape[1],
        )
        mean, _, _ = transform_tlb_sampled(
            self.x, jl_transform(self.x, k, seed), pairs
        )
        return k, float(mean), mean >= self.cfg.target_tlb, pairs.shape[0]


_REDUCERS: dict[str, type] = {
    "pca": PcaDropReducer,
    "fft": FftReducer,
    "paa": PaaReducer,
    "dwt": DwtReducer,
    "jl": JlReducer,
}

REDUCER_METHODS: tuple[str, ...] = tuple(_REDUCERS)


def make_reducer(
    method: str,
    x: np.ndarray,
    cfg: DropConfig | None = None,
    cost: CostFn | None = None,
    *,
    device: str | torch.device = "cuda",
) -> Reducer:
    """Build the Reducer for ``method``. ``device`` goes to
    ``PcaDropReducer``; the single-shot baselines compute on the host."""
    try:
        cls = _REDUCERS[method]
    except KeyError:
        raise KeyError(
            f"unknown reduction method {method!r}; know {REDUCER_METHODS}"
        ) from None
    if cls is PcaDropReducer:
        return PcaDropReducer(x, cfg, cost, device=device)
    return cls(x, cfg, cost)


def reduce(
    x: np.ndarray,
    method: str = "pca",
    cfg: DropConfig | None = None,
    cost: CostFn | None = None,
    *,
    device: str | torch.device = "cuda",
) -> ReduceResult:
    """Run any method's Reducer to completion — the method-agnostic
    generalization of ``drop()`` (which equals ``reduce(x, "pca", ...)``)."""
    runner = make_reducer(method, x, cfg, cost, device=device)
    while runner.step():
        pass
    return runner.result()
