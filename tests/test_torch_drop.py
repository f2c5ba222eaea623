"""Whole-loop DROP parity: the port on the CPU against the JAX package.

Both run the full schedule (``min_iterations=99``: Eq. 2 reads the wall
clock, so early termination is not comparable). The numpy sample and pair
streams are shared; for ``svd="halko"`` the port's Ω is replayed from the
reference's key chain (``PRNGKey(seed)``, one ``split`` per iteration).
Per iteration, sample size, pairs used and k must be identical and the TLB
estimate within ``TLB_TOL``; the final bases must span the same subspace.

The data has margin: the test fails loudly if a TLB mean the reference
compared with the target lies within ``MARGIN`` of it, where float32
differences between the packages could flip the choice of k.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.tlb as r_tlb
import repro_torch.core.halko as t_halko
from repro.core import DropConfig as RefConfig
from repro.core import drop as ref_drop
from repro_torch.core import DropConfig, drop
from repro_torch.data import sinusoid_mixture

# per-pair TLB values differ by float32 rounding, and near-degenerate
# trailing directions of a small sample differ between LAPACK builds; both
# move a mean over <= 800 pairs by well under this
TLB_TOL = 1e-3
MARGIN = 1e-3
PROJ_TOL = 1e-4


def replay_reference_omega(seed):
    """A stand-in for ``_draw_omega`` that draws what the reference's
    ``svd_halko`` draws: one split of the key chain per call."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(d, l, generator, device):
        state["key"], sub = jax.random.split(state["key"])
        omega = np.array(jax.random.normal(sub, (d, l), dtype=jnp.float32))
        return torch.from_numpy(omega).to(device)

    return draw


def record_reference_decisions(monkeypatch, target):
    """The TLB means the reference compares with the target: the mean of
    every binary-search probe (at every pair doubling), and for each
    all-prefix estimate the two means either side of the target (TLB grows
    with k, so only those two decide the smallest satisfying k)."""
    seen = []
    ci = r_tlb.gaussian_ci

    def recording_ci(vals, confidence):
        out = ci(vals, confidence)
        seen.append(out[0])
        return out

    all_k = r_tlb.TLBEstimator.estimate_all_k

    def recording_all_k(self, target_, initial_pairs=100, max_pairs=6400):
        mean, lo, hi, p = all_k(self, target_, initial_pairs, max_pairs)
        first = int(np.searchsorted(mean, target))
        seen.extend(mean[max(first - 1, 0) : first + 1].tolist())
        return mean, lo, hi, p

    monkeypatch.setattr(r_tlb, "gaussian_ci", recording_ci)
    monkeypatch.setattr(r_tlb.TLBEstimator, "estimate_all_k", recording_all_k)
    return seen


@pytest.fixture(scope="module")
def data():
    return sinusoid_mixture(600, 64, rank=8, seed=1)[0]


@pytest.mark.parametrize("search", ["binary", "prefix"])
@pytest.mark.parametrize("svd", ["full", "halko"])
def test_drop_whole_loop_parity(monkeypatch, data, svd, search):
    kw = dict(target_tlb=0.98, min_iterations=99, svd=svd, search=search, seed=0)
    seen = record_reference_decisions(monkeypatch, kw["target_tlb"])
    want = ref_drop(data, RefConfig(use_kernels=True, **kw))
    closest = min(abs(v - kw["target_tlb"]) for v in seen)
    assert closest > MARGIN, f"data has no margin: a reference TLB lies {closest:.2e} from the target"

    monkeypatch.setattr(t_halko, "_draw_omega", replay_reference_omega(kw["seed"]))
    got = drop(data, DropConfig(**kw), device="cpu")

    assert len(got.iterations) == len(want.iterations) == 10
    for g, w in zip(got.iterations, want.iterations):
        assert (g.i, g.sample_size, g.k, g.pairs_used, g.satisfied) == (
            w.i, w.sample_size, w.k, w.pairs_used, w.satisfied
        )
        assert abs(g.tlb_estimate - w.tlb_estimate) < TLB_TOL
    assert (got.k, got.satisfied) == (want.k, want.satisfied)
    assert abs(got.tlb_estimate - want.tlb_estimate) < TLB_TOL
    assert isinstance(got.v, np.ndarray) and got.v.shape == want.v.shape
    np.testing.assert_allclose(got.mean, np.asarray(want.mean), atol=1e-5)
    np.testing.assert_allclose(got.v @ got.v.T, want.v @ want.v.T, atol=PROJ_TOL)
