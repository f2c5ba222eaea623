"""DROP driver — paper Algorithm 2.

    do:
        X_i   = SAMPLE(X, SAMPLE-SCHEDULE(i))          (§3.3)
        T_k_i = COMPUTE-BASIS(X, X_i, B)               (§3.4)
    while CHECK-PROGRESS(C_m, k_i, r_i, i++)           (§3.5)

The loop is host-driven (termination is data-dependent). The data is moved
to the device once; every sample and TLB pair batch is gathered there, and
the heavy per-iteration work (centering, SVD-Halko through kernel K1, the
pairwise TLB table through kernel K2) runs there.

The loop body lives in ``PcaDropReducer``, a resumable one-iteration-at-a-
time state machine; ``drop()`` drives it to completion.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import progress as progress_mod
from repro_torch.core import sampling as sampling_mod
from repro_torch.core.basis_search import compute_basis
from repro_torch.core.cost import knn_cost
from repro_torch.core.types import CostFn, DropConfig, IterationRecord, ReduceResult
from repro_torch.utils import Clock, resolve_device, synchronize

# Extra basis columns kept beyond k for subspace tracking (the JAX package's
# ``core/subspace.py::TRACK_HEADROOM``); the tracker itself is not ported yet.
TRACK_HEADROOM = 8


class PcaDropReducer:
    """Resumable DROP optimizer state for one query.

    Each ``step()`` runs exactly one Algorithm-2 iteration (sample → fit →
    TLB-search → progress check) and returns True while more iterations
    remain. All RNG streams are owned by the reducer: the numpy sample and
    pair streams are the JAX package's, and Halko's Ω comes from a host
    ``torch.Generator`` seeded with ``cfg.seed``.

    ``device`` is where the work runs: "cuda" (the default) launches the
    hand-written kernels and raises without a GPU; "cpu" runs their plain
    PyTorch versions.
    """

    method = "pca"
    cacheable = True
    supports_update = False  # update() waits for the subspace tracker

    def __init__(
        self,
        x: np.ndarray,
        cfg: DropConfig | None = None,
        cost: CostFn | None = None,
        *,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg or DropConfig()
        self.cost = cost if cost is not None else knn_cost(x.shape[0])
        self.x = np.ascontiguousarray(x, dtype=np.float32)
        self._x_dev = torch.from_numpy(self.x).to(self.device)
        m = self.x.shape[0]

        self._rng = np.random.default_rng(self.cfg.seed)
        self._pair_rng = np.random.default_rng(self.cfg.seed + 1)
        self._omega_gen = torch.Generator().manual_seed(self.cfg.seed)

        self.sizes = sampling_mod.schedule_sizes(m, self.cfg.schedule)
        self.records: list[IterationRecord] = []
        self._hard_points: np.ndarray | None = None
        self.prev_k: int | None = None
        self._best: dict | None = None
        self.total_runtime = 0.0
        self._i = 0
        self.done = False
        self._clock = Clock()

    def step(self) -> bool:
        """Run one iteration; returns True iff the query still has work."""
        if self.done:
            return False
        i, size = self._i, self.sizes[self._i]
        m = self.x.shape[0]

        self._clock.restart()
        idx = sampling_mod.draw_sample(
            m,
            size,
            self._rng,
            hard_points=self._hard_points,
            reuse_fraction=self.cfg.reuse_fraction,
        )
        sample = self._x_dev[torch.from_numpy(idx).to(self.device)]
        res = compute_basis(
            self._x_dev, sample, self.prev_k, self.cfg, self._omega_gen,
            self._pair_rng,
        )
        # r_i feeds Eq. 2: it must cover this iteration's device work, not
        # only its launches
        synchronize(self.device)
        r_i = self._clock.elapsed()
        self.total_runtime += r_i

        obj_i = self.total_runtime + self.cost(res.k)
        self.records.append(
            IterationRecord(
                i=i,
                sample_size=size,
                k=res.k,
                tlb_estimate=res.tlb_mean,
                runtime_s=r_i,
                objective=obj_i,
                satisfied=res.satisfied,
                pairs_used=res.pairs_used,
            )
        )

        # keep the best basis: among satisfying ones the lowest k wins; when
        # none satisfies yet, the highest-TLB basis wins (k is meaningless
        # until the constraint is met)
        if res.satisfied:
            rank = (0, res.k, -res.tlb_mean)
        else:
            rank = (1, -res.tlb_mean, res.k)
        if self._best is None or rank < self._best["rank"]:
            self._best = {
                "rank": rank,
                "v": res.v_full[:, : res.k],
                # wider slice for subspace tracking (a later slice of the
                # port): trailing directions dropped from the served map still
                # carry energy a future suffix merge needs
                "v_track": res.v_full[:, : res.k + TRACK_HEADROOM],
                "mean": res.mean,
                "k": res.k,
                "tlb": res.tlb_mean,
                "satisfied": res.satisfied,
            }

        # importance sampling state for the next iteration (§3.3.2)
        pts, scores = res.estimator.point_scores(res.k)
        self._hard_points = sampling_mod.hard_points_from_scores(
            pts, scores, quantile=self.cfg.reuse_fraction
        )
        if res.satisfied:
            self.prev_k = res.k  # §3.4.3: shrink the Halko rank later on

        # CHECK-PROGRESS (§3.5): estimate next iteration, Eq. 2 stopping rule
        self._i += 1
        if self._i >= len(self.sizes) or progress_mod.should_terminate(
            self.records, self.sizes[self._i], self.cost,
            min_iterations=self.cfg.min_iterations,
        ):
            self.done = True
        return not self.done

    def result(self) -> ReduceResult:
        """The best basis found so far (valid once at least one step ran)."""
        if self._best is None:
            raise RuntimeError("result() before any step()")
        return ReduceResult(
            v=np.asarray(self._best["v"]),
            mean=np.asarray(self._best["mean"]),
            k=int(self._best["k"]),
            tlb_estimate=float(self._best["tlb"]),
            satisfied=bool(self._best["satisfied"]),
            runtime_s=self.total_runtime,
            iterations=self.records,
            method=self.method,
        )

    def tracker(self):
        """Subspace-tracker state for the best basis (not ported yet)."""
        raise NotImplementedError(
            "subspace tracking is ROADMAP open item 8 (core/subspace.py), "
            "a later slice of the port"
        )

    def update(self, suffix: np.ndarray) -> ReduceResult:
        """Fold appended rows into the fitted basis (not ported yet)."""
        raise NotImplementedError(
            "suffix updates need the subspace tracker, ROADMAP open item 8 "
            "(core/subspace.py), a later slice of the port"
        )


def drop(
    x: np.ndarray,
    cfg: DropConfig | None = None,
    cost: CostFn | None = None,
    *,
    device: str | torch.device = "cuda",
) -> ReduceResult:
    """Run DROP on data matrix ``x`` (m, d) on ``device``. Returns the
    lowest-dimensional TLB-preserving transformation found, per the
    objective R + C_m(k)."""
    reducer = PcaDropReducer(x, cfg, cost, device=device)
    while reducer.step():
        pass
    return reducer.result()
