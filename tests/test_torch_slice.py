"""The port's main path end to end, its interop, and its rules.

* ``drop`` -> ``transform`` -> ``nearest_neighbors`` on the CPU against the
  JAX package's ``DropConfig(use_kernels=True)`` path.
* A fitted map carried from either package transforms identically in the
  other.
* No module of ``src/repro_torch/`` and not ``chip_smoke.py`` imports JAX or
  the JAX package.
* The entry points default to the GPU and raise without one.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core.halko as t_halko
from repro.analytics import nearest_neighbors as ref_nn
from repro.core import DropConfig as RefConfig
from repro.core import drop as ref_drop
from repro.core.types import ReduceResult as RefResult
from repro_torch.analytics import (
    dbscan,
    dbscan_legacy,
    gaussian_kde,
    gaussian_kde_legacy,
    nearest_neighbors,
    pairwise_knn,
)
from repro_torch.core import DropConfig, PcaDropReducer, drop, reduce
from repro_torch.pipeline import WorkloadOptimizer, run_downstream
from repro_torch.data import sinusoid_mixture
from repro_torch.interop import result_from_reference, result_to_arrays
from test_torch_drop import TLB_TOL, replay_reference_omega

ROOT = Path(__file__).resolve().parents[1]
# relative gap between nearest and second-nearest squared distance on the
# reduced data; the two packages' bases differ by ~1e-5 (projector), which
# moves reduced distances far less
KNN_GAP = 1e-3


@pytest.fixture(scope="module")
def data():
    return sinusoid_mixture(600, 64, rank=8, seed=1)


def test_main_path_matches_reference(monkeypatch, data):
    x, _ = data
    kw = dict(target_tlb=0.98, min_iterations=99, seed=0)
    want = ref_drop(x, RefConfig(use_kernels=True, **kw))
    want_xt = want.transform(x)
    want_nn = ref_nn(want_xt, use_kernels=True)

    monkeypatch.setattr(t_halko, "_draw_omega", replay_reference_omega(kw["seed"]))
    got = drop(x, DropConfig(**kw), device="cpu")
    got_xt = got.transform(x)
    got_nn = nearest_neighbors(got_xt, device="cpu")

    assert (got.k, got.satisfied) == (want.k, want.satisfied)
    assert abs(got.tlb_estimate - want.tlb_estimate) < TLB_TOL
    assert got_xt.shape == want_xt.shape == (600, want.k)
    assert np.isfinite(got_xt).all()
    # exact indices wherever the reference's reduced data has margin; on a
    # near-tie row either package may pick either of the tied rows
    r64 = want_xt.astype(np.float64)
    d2 = ((r64[:, None, :] - r64[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    two = np.sort(d2, axis=1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) > KNN_GAP * two[:, 1]
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(got_nn[clear], want_nn[clear])
    rows = np.arange(600)
    np.testing.assert_array_less(
        d2[rows, got_nn] - two[:, 0], KNN_GAP * two[:, 1] + 1e-12
    )


def test_interop_round_trip(data):
    x, _ = data
    y = x[:50] * 1.5
    cfg = dict(target_tlb=0.95, min_iterations=99, svd="full", seed=2)
    ref_fit = ref_drop(x[:200], RefConfig(**cfg))
    carried = result_from_reference(ref_fit)
    np.testing.assert_array_equal(carried.transform(y), ref_fit.transform(y))
    assert len(carried.iterations) == len(ref_fit.iterations)
    assert carried.iterations[-1].k == ref_fit.iterations[-1].k

    port_fit = drop(x[:200], DropConfig(**cfg), device="cpu")
    back = RefResult(**result_to_arrays(port_fit))
    np.testing.assert_array_equal(back.transform(y), port_fit.transform(y))
    assert (back.k, back.satisfied, back.method) == (port_fit.k, port_fit.satisfied, "pca")


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20 and files[-1].exists()
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_default_device_raises_without_a_gpu(monkeypatch, data):
    """Leaving the default device in place asks for the GPU; on a host with
    none the call raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = data[0][:40]
    for call in (
        lambda: drop(x),
        lambda: PcaDropReducer(x),
        lambda: nearest_neighbors(x),
        lambda: pairwise_knn(x),
        lambda: dbscan(x),
        lambda: dbscan_legacy(x),
        lambda: gaussian_kde(x),
        lambda: gaussian_kde_legacy(x),
        lambda: reduce(x, "pca"),
        lambda: WorkloadOptimizer(),
        lambda: run_downstream("kde", x),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_tracker_and_update_are_not_ported_yet(data):
    reducer = PcaDropReducer(data[0][:100], DropConfig(min_iterations=99), device="cpu")
    reducer.step()
    with pytest.raises(NotImplementedError, match="ROADMAP open item 8"):
        reducer.tracker()
    with pytest.raises(NotImplementedError, match="ROADMAP open item 8"):
        reducer.update(data[0][100:110])
