"""Core modules of the PyTorch port against the JAX package, on the CPU.

The numpy modules (sampling, progress, bucketing, cost, the TLB helpers)
must give identical outputs; PCA, Halko and the TLB estimator agree within
float32 tolerances, with sign-invariant comparisons for bases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.bucketing as r_bucketing
import repro.core.cost as r_cost
import repro.core.halko as r_halko
import repro.core.pca as r_pca
import repro.core.progress as r_progress
import repro.core.sampling as r_sampling
import repro.core.tlb as r_tlb
import repro.core.types as r_types
import repro_torch.core.bucketing as t_bucketing
import repro_torch.core.cost as t_cost
import repro_torch.core.halko as t_halko
import repro_torch.core.pca as t_pca
import repro_torch.core.progress as t_progress
import repro_torch.core.sampling as t_sampling
import repro_torch.core.tlb as t_tlb
import repro_torch.core.types as t_types
from repro_torch.data import sinusoid_mixture

# float32 results computed by two BLAS/LAPACK stacks in different orders
F32_TOL = 1e-5


def _data(m=300, d=48, rank=5, seed=3):
    return sinusoid_mixture(m, d, rank=rank, seed=seed)[0]


def _principal_cosines(a, b):
    """Cosines of the principal angles between span(a) and span(b)."""
    qa, _ = np.linalg.qr(np.asarray(a, np.float64))
    qb, _ = np.linalg.qr(np.asarray(b, np.float64))
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


# ------------------------------------------------------ numpy copies: exact


def test_sampling_identical():
    for m, sched in ((1000, r_types.DEFAULT_SCHEDULE), (37, (0.1, 0.1, 0.5, 1.0))):
        assert t_sampling.schedule_sizes(m, sched) == r_sampling.schedule_sizes(m, sched)
    hard = np.array([5, 9, 9, 200, 3], dtype=np.int32)
    for hp in (None, hard):
        got = t_sampling.draw_sample(500, 60, np.random.default_rng(4), hard_points=hp)
        want = r_sampling.draw_sample(500, 60, np.random.default_rng(4), hard_points=hp)
        np.testing.assert_array_equal(got, want)
    pts = np.arange(50, dtype=np.int32)
    scores = np.random.default_rng(5).uniform(size=50).astype(np.float32)
    np.testing.assert_array_equal(
        t_sampling.hard_points_from_scores(pts, scores),
        r_sampling.hard_points_from_scores(pts, scores),
    )


def _records(mod, ks, runtimes, satisfied=True):
    return [
        mod.IterationRecord(i, s, k, 0.99, r, 0.0, satisfied, 100)
        for i, (s, k, r) in enumerate(zip((10, 20, 30), ks, runtimes))
    ]


@pytest.mark.parametrize("ks", [(40, 30, 25), (10, 10, 10), (5, 9, 14)])
@pytest.mark.parametrize("satisfied", [True, False])
def test_progress_identical(ks, satisfied):
    runtimes = (0.01, 0.02, 0.035)
    cost = r_cost.knn_cost(1000)
    want_recs = _records(r_types, ks, runtimes, satisfied)
    got_recs = _records(t_types, ks, runtimes, satisfied)
    assert t_progress.estimate_next(got_recs, 60) == r_progress.estimate_next(want_recs, 60)
    for n in (2, 3, 4):
        assert t_progress.should_terminate(
            got_recs, 60, t_cost.knn_cost(1000), min_iterations=n
        ) == r_progress.should_terminate(want_recs, 60, cost, min_iterations=n)


def test_bucketing_identical():
    rb, tb = r_bucketing.ShapeBucketCache(), t_bucketing.ShapeBucketCache()
    for cap in (1, 5, 31, 32, 33, 80, 100, 1000):
        for hard in (1, 40, 80, 1024):
            assert tb.bucket_rank(cap, hard) == rb.bucket_rank(cap, hard)
    for n in (1, 63, 64, 65, 600, 8000):
        assert tb.bucket_rows(n) == rb.bucket_rows(n)
        assert t_bucketing.round_up(n, 7) == r_bucketing.round_up(n, 7)


def test_cost_identical():
    for k in (0, 1, 7, 96):
        for name in ("knn", "dbscan", "kde"):
            for legacy in (False, True):
                assert t_cost.downstream_cost(name, 800, legacy_cost=legacy)(k) == (
                    r_cost.downstream_cost(name, 800, legacy_cost=legacy)(k)
                )
        assert t_cost.knn_cost(8000)(k) == r_cost.knn_cost(8000)(k)
        assert t_cost.linear_cost(8000)(k) == r_cost.linear_cost(8000)(k)
        assert t_cost.zero_cost()(k) == r_cost.zero_cost()(k) == 0.0
    with pytest.raises(KeyError):
        t_cost.downstream_cost("svm", 10)


def test_calibrate_pairwise_intercept_uses_the_port_knn():
    coeff = t_cost.calibrate_pairwise_intercept(m_probe=200, iters=1, device="cpu")
    assert np.isfinite(coeff) and coeff >= 0.0


def test_tlb_numpy_helpers_identical():
    x = _data()
    pairs = r_tlb.sample_pairs(300, 120, np.random.default_rng(6))
    np.testing.assert_array_equal(t_tlb.sample_pairs(300, 120, np.random.default_rng(6)), pairs)
    v = np.linalg.svd(x - x.mean(0), full_matrices=False)[2].T[:, :10]
    expansion = x @ v
    np.testing.assert_array_equal(
        t_tlb.nested_prefix_tlb(x, expansion, pairs), r_tlb.nested_prefix_tlb(x, expansion, pairs)
    )
    assert t_tlb.nested_min_k(x, expansion, 0.9, pairs)[0] == r_tlb.nested_min_k(x, expansion, 0.9, pairs)[0]
    assert t_tlb.transform_tlb_sampled(x, expansion, pairs) == r_tlb.transform_tlb_sampled(x, expansion, pairs)
    fn = lambda data, k: data @ v[:, :k]  # noqa: E731
    assert t_tlb.transform_min_k(x, fn, 0.9, pairs, 10) == r_tlb.transform_min_k(x, fn, 0.9, pairs, 10)
    vals = np.random.default_rng(7).uniform(size=40)
    assert t_tlb.gaussian_ci(vals, 0.95) == r_tlb.gaussian_ci(vals, 0.95)
    assert t_tlb.exact_tlb(x[:80], v[:, :4]) == r_tlb.exact_tlb(x[:80], v[:, :4])


# ------------------------------------------------------ PCA and Halko


def test_center_and_center_masked_match_reference():
    x = _data(m=70, d=20)
    xbar, c = t_pca.center(torch.from_numpy(x))
    rbar, rc = r_pca.center(jnp.asarray(x))
    np.testing.assert_allclose(xbar.numpy(), np.asarray(rbar), atol=F32_TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=F32_TOL)
    padded = np.concatenate([x, np.zeros((26, 20), np.float32)])
    mask = np.arange(96) < 70
    xbar, c = t_pca.center_masked(torch.from_numpy(padded), torch.from_numpy(mask))
    rbar, rc = r_pca.center_masked(jnp.asarray(padded), jnp.asarray(mask))
    np.testing.assert_allclose(xbar.numpy(), np.asarray(rbar), atol=F32_TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=F32_TOL)
    assert not c[70:].any()


def test_pca_fit_svd_and_spectrum_match_reference():
    x = _data()
    mean, v, s = t_pca.pca_fit_svd(torch.from_numpy(x), k=5)
    rmean, rv, rs = r_pca.pca_fit_svd(jnp.asarray(x), k=5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(rmean), atol=F32_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-4)
    np.testing.assert_allclose(_principal_cosines(v.numpy(), np.asarray(rv)), 1.0, atol=1e-4)
    y = t_pca.pca_transform(torch.from_numpy(x), mean, v)
    assert y.shape == (300, 5)
    np.testing.assert_array_equal(t_pca.explained_spectrum(x), r_pca.explained_spectrum(x))


@pytest.mark.parametrize("k,power_iters", [(5, 1), (12, 0), (12, 2)])
def test_svd_halko_matches_reference_with_the_same_omega(monkeypatch, k, power_iters):
    """Ω replayed from the reference's key: the top-k subspace agrees by
    principal angles and the singular values agree."""
    x = _data()
    c = x - x.mean(0)
    key = jax.random.PRNGKey(11)
    l = min(k + 5, *c.shape)
    omega = np.array(jax.random.normal(key, (c.shape[1], l), dtype=jnp.float32))
    monkeypatch.setattr(t_halko, "_draw_omega", lambda d, l_, g, dev: torch.from_numpy(omega).to(dev))
    v, s = t_halko.svd_halko(torch.from_numpy(c), k, torch.Generator(), power_iters=power_iters)
    rv, rs = r_halko.svd_halko(jnp.asarray(c), k, key, power_iters=power_iters, use_kernels=True)
    assert v.shape == (48, k)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-4)
    # the leading directions (well above the noise floor) coincide
    np.testing.assert_allclose(_principal_cosines(v[:, :5].numpy(), np.asarray(rv)[:, :5]), 1.0, atol=1e-4)


def test_svd_halko_matches_numpy_oracle(monkeypatch):
    x = _data()
    c = x - x.mean(0)
    rng = np.random.default_rng(0)
    monkeypatch.setattr(
        t_halko, "_draw_omega",
        lambda d, l, g, dev: torch.from_numpy(rng.normal(size=(d, l)).astype(np.float32)).to(dev),
    )
    v, s = t_halko.svd_halko(torch.from_numpy(c), 8, torch.Generator())
    nv, ns = t_halko.svd_halko_np(c, 8, seed=0)
    np.testing.assert_allclose(s.numpy(), ns, rtol=1e-4)
    np.testing.assert_allclose(_principal_cosines(v[:, :5].numpy(), nv[:, :5]), 1.0, atol=1e-4)


def test_draw_omega_is_device_independent_and_seeded():
    a = t_halko._draw_omega(30, 7, torch.Generator().manual_seed(3), torch.device("cpu"))
    b = t_halko._draw_omega(30, 7, torch.Generator().manual_seed(3), torch.device("cpu"))
    assert a.shape == (30, 7) and a.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# ------------------------------------------------------ TLB estimator


def test_prefix_tlb_table_matches_reference():
    x = _data()
    v = np.linalg.svd(x - x.mean(0), full_matrices=False)[2].T[:, :20].copy()
    pairs = r_tlb.sample_pairs(300, 64, np.random.default_rng(8))
    xi, xj = x[pairs[:, 0]], x[pairs[:, 1]]
    got = t_tlb.prefix_tlb_table(torch.from_numpy(xi), torch.from_numpy(xj), torch.from_numpy(v))
    want = r_tlb.prefix_tlb_table(jnp.asarray(xi), jnp.asarray(xj), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


@pytest.mark.parametrize("target", [0.9, 0.99])
def test_tlb_estimator_matches_reference(target):
    """Same data, basis and pair seed: same pairs, same tables within
    tolerance, same CI decisions (pairs used) and the same worst points."""
    x = _data()
    v = np.linalg.svd(x - x.mean(0), full_matrices=False)[2].T[:, :24].copy()
    got = t_tlb.TLBEstimator(torch.from_numpy(x), torch.from_numpy(v), np.random.default_rng(9))
    want = r_tlb.TLBEstimator(x, jnp.asarray(v), np.random.default_rng(9), use_kernels=True)
    for k in (1, 3, 6, 24):
        e_got = got.estimate_at_k(k, target, max_pairs=800)
        e_want = want.estimate_at_k(k, target, max_pairs=800)
        assert e_got.pairs_used == e_want.pairs_used
        np.testing.assert_allclose(
            (e_got.mean, e_got.lo, e_got.hi), (e_want.mean, e_want.lo, e_want.hi), atol=F32_TOL
        )
    mean_g, lo_g, hi_g, p_g = got.estimate_all_k(target, max_pairs=800)
    mean_w, lo_w, hi_w, p_w = want.estimate_all_k(target, max_pairs=800)
    assert p_g == p_w
    np.testing.assert_allclose(mean_g, mean_w, atol=F32_TOL)
    np.testing.assert_array_equal(got._pairs, want._pairs)
    np.testing.assert_allclose(got.table(p_g), want.table(p_w), atol=F32_TOL)
    pts_g, sc_g = got.point_scores(3)
    pts_w, sc_w = want.point_scores(3)
    np.testing.assert_array_equal(pts_g, pts_w)
    np.testing.assert_allclose(sc_g, sc_w, atol=F32_TOL)
