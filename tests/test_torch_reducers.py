"""The Reducer protocol and the baselines of the PyTorch port against the
JAX package, on the CPU.

The baselines are host numpy in both packages (float64 expansions, the same
``default_rng`` streams), so expansions, operators, k, TLB and the satisfied
flag must be bit-identical. ``reduce(x, "pca")`` is DROP: it is held to the
reference's ``drop`` as ``tests/test_torch_drop.py`` holds ``drop`` (full
schedule, Ω replayed, margin checked, TLB within ``TLB_TOL``).
"""

import numpy as np
import pytest

import repro_torch.core.halko as t_halko
from repro.baselines.dwt import haar_expansion as ref_haar
from repro.baselines.fft import fft_real_expansion as ref_fft
from repro.baselines.jl import jl_operator as ref_jl_operator
from repro.baselines.paa import paa_transform as ref_paa
from repro.core import DropConfig as RefConfig
from repro.core import drop as ref_drop
from repro.core import make_reducer as ref_make_reducer
from repro_torch.baselines.dwt import haar_expansion
from repro_torch.baselines.fft import fft_real_expansion
from repro_torch.baselines.jl import jl_operator
from repro_torch.baselines.paa import paa_transform
from repro_torch.core import (
    REDUCER_METHODS,
    DropConfig,
    PcaDropReducer,
    Reducer,
    drop,
    make_reducer,
    reduce,
)
from repro_torch.data import ecg_like, sinusoid_mixture
from test_torch_drop import MARGIN, TLB_TOL, record_reference_decisions, replay_reference_omega

BASELINES = ("fft", "paa", "dwt", "jl")


@pytest.fixture(scope="module")
def ecg():
    return ecg_like(500, 96, seed=0)[0]


@pytest.mark.parametrize("d", [1, 2, 37, 96, 100])
def test_expansions_bit_match_reference(d):
    x = np.random.default_rng(d).normal(size=(40, d)).astype(np.float32)
    np.testing.assert_array_equal(fft_real_expansion(x), ref_fft(x))
    np.testing.assert_array_equal(haar_expansion(x), ref_haar(x))
    for k in (1, 3, d // 2 + 1, d, d + 5):
        np.testing.assert_array_equal(paa_transform(x, k), ref_paa(x, k))
        np.testing.assert_array_equal(jl_operator(d, k, seed=3), ref_jl_operator(d, k, seed=3))


@pytest.mark.parametrize("target", [0.9, 0.98])
@pytest.mark.parametrize("method", BASELINES)
def test_single_shot_reducers_match_reference(ecg, method, target):
    cfg, ref_cfg = DropConfig(target_tlb=target, seed=2), RefConfig(target_tlb=target, seed=2)
    got = reduce(ecg, method, cfg, device="cpu")
    runner = ref_make_reducer(method, ecg, ref_cfg)
    while runner.step():
        pass
    want = runner.result()
    assert (got.method, got.k, got.tlb_estimate, got.satisfied) == (
        want.method, want.k, want.tlb_estimate, want.satisfied
    )
    np.testing.assert_array_equal(got.v, want.v)
    np.testing.assert_array_equal(got.transform(ecg), want.transform(ecg))
    assert len(got.iterations) == 1 and got.iterations[0].pairs_used == cfg.max_pairs


def test_reducer_protocol_and_factory(ecg):
    assert REDUCER_METHODS == ("pca", "fft", "paa", "dwt", "jl")
    for method in REDUCER_METHODS:
        runner = make_reducer(method, ecg[:60], DropConfig(min_iterations=99), device="cpu")
        assert isinstance(runner, Reducer) and runner.method == method
        assert not runner.supports_update and runner.cacheable == (method != "jl")
        with pytest.raises(RuntimeError):
            runner.result()  # before any step
        while runner.step():
            pass
        assert runner.done and not runner.step()
        with pytest.raises(NotImplementedError):
            runner.update(ecg[60:70])
    assert isinstance(make_reducer("pca", ecg[:60], device="cpu"), PcaDropReducer)
    with pytest.raises(KeyError, match="unknown reduction method"):
        make_reducer("umap", ecg)


def test_reduce_pca_is_drop(monkeypatch):
    x = sinusoid_mixture(600, 64, rank=8, seed=1)[0]
    kw = dict(target_tlb=0.98, min_iterations=99, seed=0)
    seen = record_reference_decisions(monkeypatch, kw["target_tlb"])
    want = ref_drop(x, RefConfig(use_kernels=True, **kw))
    closest = min(abs(v - kw["target_tlb"]) for v in seen)
    assert closest > MARGIN, f"data has no margin: a reference TLB lies {closest:.2e} from the target"

    monkeypatch.setattr(t_halko, "_draw_omega", replay_reference_omega(kw["seed"]))
    got = reduce(x, "pca", DropConfig(**kw), device="cpu")
    monkeypatch.setattr(t_halko, "_draw_omega", replay_reference_omega(kw["seed"]))
    same = drop(x, DropConfig(**kw), device="cpu")

    assert got.method == "pca" and len(got.iterations) == len(want.iterations) == 10
    for g, s, w in zip(got.iterations, same.iterations, want.iterations):
        assert (g.sample_size, g.k, g.pairs_used, g.satisfied) == (
            w.sample_size, w.k, w.pairs_used, w.satisfied
        )
        assert (g.k, g.tlb_estimate) == (s.k, s.tlb_estimate)
        assert abs(g.tlb_estimate - w.tlb_estimate) < TLB_TOL
    assert (got.k, got.satisfied) == (want.k, want.satisfied)
    np.testing.assert_array_equal(got.v, same.v)
