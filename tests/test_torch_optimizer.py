"""The §4.4 workload optimizer of the PyTorch port against the JAX package,
on the CPU.

Per method, k, TLB and the satisfied flag must equal the reference
optimizer's: bit-identical for the host-numpy baselines, and for PCA
(DROP, full schedule, Ω replayed as in ``tests/test_torch_drop.py``) the
same k and flag with TLB within ``TLB_TOL``, on data checked for margin.
Which method is chosen depends on measured wall clock, so it is not
compared, and no test asserts a time.
"""

import numpy as np
import pytest

import repro_torch.core.halko as t_halko
from repro.core import DropConfig as RefConfig
from repro.pipeline import WorkloadOptimizer as RefOptimizer
from repro_torch.analytics import dbscan, gaussian_kde, nearest_neighbors
from repro_torch.core import DropConfig
from repro_torch.core.cost import downstream_cost
from repro_torch.data import sinusoid_mixture
from repro_torch.pipeline import DOWNSTREAMS, WorkloadOptimizer, run_downstream
from test_torch_drop import MARGIN, TLB_TOL, record_reference_decisions, replay_reference_omega

METHODS = ("pca", "fft", "paa", "dwt", "jl")
# a target where DROP's decisive TLB means on this data keep margin (at
# 0.9 one lies 3.2e-4 from the target, at 0.98 1.0e-4; at 0.95 2.7e-2)
TARGET = 0.95


@pytest.fixture(scope="module")
def small():
    return sinusoid_mixture(300, 32, rank=3, seed=7)[0]


def test_per_method_outcomes_match_reference(monkeypatch, small):
    kw = dict(target_tlb=TARGET, min_iterations=99, seed=0)
    want = RefOptimizer(methods=METHODS, cfg=RefConfig(**kw)).optimize(small, "knn")
    # margin matters for DROP only: the baselines compute the same numbers
    seen = record_reference_decisions(monkeypatch, TARGET)
    RefOptimizer(methods=("pca",), cfg=RefConfig(**kw)).optimize(small, "knn")
    closest = min(abs(v - TARGET) for v in seen)
    assert closest > MARGIN, f"data has no margin: a reference TLB lies {closest:.2e} from the target"

    monkeypatch.setattr(t_halko, "_draw_omega", replay_reference_omega(kw["seed"]))
    got = WorkloadOptimizer(methods=METHODS, cfg=DropConfig(**kw), device="cpu").optimize(small, "knn")
    assert set(got.outcomes) == set(want.outcomes) == set(METHODS)
    cost = downstream_cost("knn", small.shape[0])
    for m in METHODS:
        g, w = got.outcomes[m], want.outcomes[m]
        assert (g.method, g.result.method, g.result.k, g.result.satisfied) == (
            w.method, w.result.method, w.result.k, w.result.satisfied
        )
        if m == "pca":
            assert abs(g.result.tlb_estimate - w.result.tlb_estimate) < TLB_TOL
        else:
            assert g.result.tlb_estimate == w.result.tlb_estimate
            np.testing.assert_array_equal(g.result.v, w.result.v)
        assert g.reduce_s > 0 and g.downstream_est_s == cost(g.result.k)
        assert g.objective == g.reduce_s + g.downstream_est_s
        assert g.downstream_s is None and g.end_to_end_s is None  # execute="none"
    assert got.chosen in got.outcomes and f"chosen={got.chosen}" in got.summary()


def test_cost_model_options(small):
    """``cost_coeff`` replaces the seconds per m^2 k; ``legacy_cost`` drops
    the k-independent m^2 term (the paper's pure model)."""
    for kw in (dict(cost_coeff=1e-9), dict(legacy_cost=True), dict(cost_coeff=1e-9, legacy_cost=True)):
        rep = WorkloadOptimizer(methods=("fft",), cfg=DropConfig(target_tlb=TARGET), device="cpu",
                                **kw).optimize(small, "dbscan")
        o = rep.outcomes["fft"]
        coeff = {"coeff": kw["cost_coeff"]} if "cost_coeff" in kw else {}
        want = downstream_cost("dbscan", 300, legacy_cost=kw.get("legacy_cost", False), **coeff)
        assert o.downstream_est_s == want(o.result.k)
        assert o.objective == o.reduce_s + o.downstream_est_s


def test_plan_orders_cheap_methods_first(small):
    opt = WorkloadOptimizer(methods=("pca", "fft", "paa"), device="cpu")
    assert opt.plan(small) == ["paa", "fft", "pca"]  # DROP last
    assert WorkloadOptimizer(methods=METHODS, device="cpu").plan(small, "kde") == [
        "paa", "dwt", "fft", "jl", "pca"
    ]


def test_optimizer_rejects_unknowns(small):
    with pytest.raises(KeyError):
        WorkloadOptimizer(methods=("pca", "umap"), device="cpu")
    opt = WorkloadOptimizer(methods=("fft",), device="cpu")
    with pytest.raises(KeyError):
        opt.optimize(small, "regression")
    with pytest.raises(ValueError):
        opt.optimize(small, "knn", execute="some")
    with pytest.raises(KeyError):
        run_downstream("regression", small, device="cpu")


def test_chosen_minimizes_objective_among_satisfied(small):
    opt = WorkloadOptimizer(
        methods=("fft", "paa", "dwt"), cfg=DropConfig(target_tlb=TARGET), device="cpu"
    )
    rep = opt.optimize(small, "kde")
    sat = {m: o for m, o in rep.outcomes.items() if o.result.satisfied}
    assert sat  # contractive methods always satisfy at full width
    assert rep.chosen == min(sat, key=lambda m: sat[m].objective)


def test_execute_chosen_runs_only_the_winner(small):
    opt = WorkloadOptimizer(
        methods=("fft", "paa"), cfg=DropConfig(target_tlb=TARGET), device="cpu"
    )
    rep = opt.optimize(small, "dbscan", execute="chosen")
    assert rep.best.downstream_s is not None and rep.best.downstream_s > 0
    assert rep.best.end_to_end_s == rep.best.reduce_s + rep.best.downstream_s
    others = [o for m, o in rep.outcomes.items() if m != rep.chosen]
    assert others and all(o.downstream_s is None for o in others)
    every = opt.optimize(small, "kde", execute="all")
    assert all(o.end_to_end_s is not None for o in every.outcomes.values())


def test_all_failing_falls_back_to_best_tlb(small):
    """When no method reaches the (impossible) target, the caller still
    gets a map — the closest-TLB one, not the cheapest failure."""
    opt = WorkloadOptimizer(methods=("fft", "jl"), cfg=DropConfig(target_tlb=1.5), device="cpu")
    rep = opt.optimize(small, "knn")
    assert not any(o.result.satisfied for o in rep.outcomes.values())
    best_tlb = max(rep.outcomes, key=lambda m: rep.outcomes[m].result.tlb_estimate)
    assert rep.chosen == best_tlb


def test_run_downstream_covers_every_task(small):
    xt = small[:, :4]
    assert set(DOWNSTREAMS) == {"knn", "dbscan", "kde"}
    np.testing.assert_array_equal(run_downstream("knn", xt, device="cpu"),
                                  nearest_neighbors(xt, device="cpu"))
    np.testing.assert_array_equal(run_downstream("dbscan", xt, device="cpu"),
                                  dbscan(xt, device="cpu"))
    np.testing.assert_array_equal(run_downstream("kde", xt, device="cpu"),
                                  gaussian_kde(xt, device="cpu"))
    assert run_downstream("kde", xt.astype(np.float64), device="cpu").shape == (300,)
