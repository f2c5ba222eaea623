"""End-to-end workload optimizer — the paper's §4.4 comparison as an API.

DROP's headline claim is not "fast PCA" but that a DR *optimizer* should
weigh reduction cost against downstream analytics cost end-to-end: FFT/PAA
fit faster, but their larger k makes every later distance computation more
expensive. ``WorkloadOptimizer`` makes that trade a decision:

    report = WorkloadOptimizer().optimize(x, downstream="knn")
    report.chosen            # e.g. "pca"
    report.best.result       # the winning ReduceResult
    report.outcomes          # per-method ReduceResults + priced objectives

For each candidate method the optimizer runs its ``Reducer`` (DROP's own
Eq.-2 stopping for PCA; one-shot searches for the baselines), prices the
downstream task via ``core.cost.downstream_cost`` (C_m(k), seconds), and
picks the method minimizing ``R + C_m(k)`` among those that satisfied the
TLB target. ``execute=`` optionally runs the analytics on the reduced data,
so the report also carries the measured end-to-end wall clock.

Candidates are walked cheapest-DR-first (``plan``) so a partial report
covers the cheap methods.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.cost import CostModel, downstream_cost
from repro_torch.core.reducer import REDUCER_METHODS, make_reducer
from repro_torch.core.types import DropConfig, ReduceResult
from repro_torch.utils import resolve_device, synchronize

# analytics runners keyed by the names core.cost.downstream_cost prices,
# each called as fn(xt, device)
DOWNSTREAMS: dict[str, Callable[[np.ndarray, torch.device], object]] = {}


def _register_downstreams() -> None:
    from repro_torch.analytics import dbscan, gaussian_kde, nearest_neighbors

    DOWNSTREAMS.update(
        knn=lambda xt, device: nearest_neighbors(xt, device=device),
        dbscan=lambda xt, device: dbscan(xt, device=device),
        kde=lambda xt, device: gaussian_kde(xt, device=device),
    )


_register_downstreams()


def run_downstream(
    name: str, xt: np.ndarray, *, device: str | torch.device = "cuda"
):
    """Execute the named analytics task on reduced data ``xt`` on
    ``device`` (each task is one pairwise scan, ``analytics.pairwise``)."""
    try:
        fn = DOWNSTREAMS[name]
    except KeyError:
        raise KeyError(
            f"unknown downstream {name!r}; know {tuple(DOWNSTREAMS)}"
        ) from None
    return fn(np.ascontiguousarray(xt, dtype=np.float32), resolve_device(device))


# DR-cost ordering for the plan: O(md) PAA, O(md) Haar, O(md log d) FFT,
# O(mdk) JL draws per probe, then DROP's sampled loop (cheap in rows touched
# but the only multi-step method)
_PLAN_ORDER = ("paa", "dwt", "fft", "jl", "pca")


@dataclass
class MethodOutcome:
    """One candidate's end-to-end accounting."""

    method: str
    result: ReduceResult
    reduce_s: float  # measured DR wall clock (R)
    downstream_est_s: float  # priced C_m(k)
    objective: float  # R + C_m(k), the paper's Problem 3.1 objective
    downstream_s: float | None = None  # measured, when executed
    end_to_end_s: float | None = None  # reduce_s + measured downstream


@dataclass
class OptimizerReport:
    downstream: str
    target_tlb: float
    chosen: str
    outcomes: dict[str, MethodOutcome] = field(default_factory=dict)

    @property
    def best(self) -> MethodOutcome:
        return self.outcomes[self.chosen]

    def summary(self) -> str:
        lines = [
            f"downstream={self.downstream} target_tlb={self.target_tlb} "
            f"chosen={self.chosen}"
        ]
        for m, o in sorted(self.outcomes.items(), key=lambda kv: kv[1].objective):
            measured = (
                f" downstream={o.downstream_s*1e3:8.1f}ms e2e={o.end_to_end_s*1e3:8.1f}ms"
                if o.end_to_end_s is not None
                else ""
            )
            lines.append(
                f"  {m:4s} k={o.result.k:4d} tlb={o.result.tlb_estimate:.4f} "
                f"satisfied={str(o.result.satisfied):5s} "
                f"R={o.reduce_s*1e3:8.1f}ms C_m(k)={o.downstream_est_s*1e3:8.1f}ms "
                f"objective={o.objective*1e3:8.1f}ms{measured}"
            )
        return "\n".join(lines)


class WorkloadOptimizer:
    """Plan and race ``Reducer``s against the end-to-end objective.

    ``methods`` — candidate operators (default: the paper's §4.4 trio plus
    DWT; pass ``REDUCER_METHODS`` for all five).
    ``cfg`` — shared ``DropConfig`` (TLB target, confidence, seeds).
    ``cost_coeff`` — override the seconds/(m^2 k) coefficient of the
    downstream cost model.
    ``legacy_cost`` — price with the paper's pure O(m^2 k) model instead of
    the default model with the k-independent O(m^2) term (the term is
    method-independent, so the choice is the same either way).
    ``device`` — where DROP's loop and the executed analytics run ("cuda"
    launches the kernels; the baselines' fits are host numpy either way).
    """

    def __init__(
        self,
        methods: Sequence[str] = ("pca", "fft", "paa", "dwt"),
        cfg: DropConfig | None = None,
        cost_coeff: float | None = None,
        legacy_cost: bool = False,
        device: str | torch.device = "cuda",
    ) -> None:
        unknown = [m for m in methods if m not in REDUCER_METHODS]
        if unknown:
            raise KeyError(f"unknown methods {unknown}; know {REDUCER_METHODS}")
        self.methods = tuple(methods)
        self.cfg = cfg or DropConfig()
        self.cost_coeff = cost_coeff
        self.legacy_cost = legacy_cost
        self.device = resolve_device(device)

    def plan(self, x: np.ndarray, downstream: str = "knn") -> list[str]:
        """Candidate evaluation order: cheapest DR first, DROP last (a
        partial report covers the cheap methods). Also validates the
        downstream name."""
        self._cost_model(downstream, x.shape[0])  # raises on unknown name
        return [m for m in _PLAN_ORDER if m in self.methods]

    def _cost_model(self, downstream: str, m: int) -> CostModel:
        if self.cost_coeff is not None:
            return downstream_cost(
                downstream, m, coeff=self.cost_coeff,
                legacy_cost=self.legacy_cost,
            )
        return downstream_cost(downstream, m, legacy_cost=self.legacy_cost)

    def optimize(
        self,
        x: np.ndarray,
        downstream: str = "knn",
        *,
        execute: str = "none",  # "none" | "chosen" | "all"
    ) -> OptimizerReport:
        """Race the candidates end-to-end and pick the objective minimizer.

        Methods that fail the TLB target cannot win (a cheap-but-lossy
        transform is not a valid answer to Problem 3.1); if every method
        fails, the best-TLB result is chosen so callers always get a map.
        """
        if execute not in ("none", "chosen", "all"):
            raise ValueError(f"execute={execute!r}")
        x = np.ascontiguousarray(x, dtype=np.float32)
        cost = self._cost_model(downstream, x.shape[0])
        report = OptimizerReport(
            downstream=downstream, target_tlb=self.cfg.target_tlb, chosen=""
        )
        for method in self.plan(x, downstream):
            t0 = time.perf_counter()
            runner = make_reducer(method, x, self.cfg, cost, device=self.device)
            while runner.step():  # PcaDropReducer synchronizes every step
                pass
            res = runner.result()
            reduce_s = time.perf_counter() - t0
            est = cost(res.k)
            report.outcomes[method] = MethodOutcome(
                method=method,
                result=res,
                reduce_s=reduce_s,
                downstream_est_s=est,
                objective=reduce_s + est,
            )

        satisfied = [
            m for m, o in report.outcomes.items() if o.result.satisfied
        ]
        if satisfied:
            report.chosen = min(
                satisfied, key=lambda m: report.outcomes[m].objective
            )
        else:  # nothing hit the target: closest TLB wins (documented)
            report.chosen = max(
                report.outcomes,
                key=lambda m: report.outcomes[m].result.tlb_estimate,
            )
        if execute != "none":
            targets = (
                report.outcomes.values()
                if execute == "all"
                else [report.best]
            )
            for o in targets:
                xt = o.result.transform(x)
                t0 = time.perf_counter()
                run_downstream(downstream, xt, device=self.device)
                synchronize(self.device)
                o.downstream_s = time.perf_counter() - t0
                o.end_to_end_s = o.reduce_s + o.downstream_s
        return report
