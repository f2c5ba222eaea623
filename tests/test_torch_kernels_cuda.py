"""Kernels K1-K5 of the PyTorch port on a CUDA GPU (marker ``cuda``).

Each hand-written kernel against its plain PyTorch version on the card, on
the JAX package's sweep shapes plus the main path's shapes and the ragged
and degenerate edges the kernels mask themselves. The file imports only
the port and torch, so it runs on a GPU host without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

On a host without CUDA every test skips.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.pairwise_reduce import ops as knn_ops
from repro_torch.kernels.pairwise_reduce.ref import (
    pairwise_dbscan_ref,
    pairwise_kde_ref,
    pairwise_knn_ref,
)
from repro_torch.kernels.pairwise_tlb import ops as tlb_ops
from repro_torch.kernels.pairwise_tlb.ref import pairwise_tlb_ref
from repro_torch.utils import resolve_device

# the JAX package's sweep shapes (tests/test_kernels.py)
MM_SHAPES = [(32, 32, 32), (48, 16, 64), (33, 17, 19), (5, 40, 3), (16, 1, 16), (1, 16, 1)]
TLB_SHAPES = [(16, 32, 16), (32, 64, 48), (19, 33, 21), (4, 8, 1), (1, 16, 16)]
KNN_SHAPES = [(32, 32, 8), (48, 80, 16), (33, 61, 7), (1, 16, 4), (3, 3, 2)]
# K4/K5: the same sweep plus ragged mk around the 32-bit word and a size
# that splits the column tiles over several blocks
PR_SHAPES = KNN_SHAPES + [(31, 31, 5), (33, 33, 5), (20, 63, 6), (97, 97, 3), (3000, 3000, 40)]
EPS32 = 2.0**-23
# a pair whose float64 d2 lies within this many float32 epsilons of
# ||q||^2 + ||x||^2 of eps^2 may fall either side on the card and the CPU
D2_ULPS = 64
# float32 sums in another order: 1e-5 at the sweep's sizes, growing with the
# square root of the contraction length; bfloat16: one output rounding
F32_TOL = 1e-5
BF16_TOL = 2e-2


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _basis(seed, d, k):
    return np.linalg.qr(_normal(seed, (d, d)))[0][:, :k].astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are compiled by nvcc for sm_90a")
    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MM_SHAPES + [(8000, 1024, 37), (70, 2000, 9)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_kernel_matches_plain(cuda_device, m, k, n, dtype):
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ta = torch.from_numpy(_normal(0, (m, k))).to(cuda_device, tdt)
    tb = torch.from_numpy(_normal(1, (k, n))).to(cuda_device, tdt)
    before = mm_ops.LAUNCHES
    got = mm_ops.matmul(ta, tb)
    torch.cuda.synchronize()
    assert mm_ops.LAUNCHES == before + 1
    want = matmul_ref(ta, tb)
    tol = F32_TOL * max(1.0, np.sqrt(k) / 4) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_matmul_kernel_transposed_operands(cuda_device):
    c = torch.from_numpy(_normal(2, (3000, 300))).to(cuda_device)
    y = torch.from_numpy(_normal(3, (3000, 40))).to(cuda_device)
    for a, b in ((c.T, y), (y.T, c)):
        got = mm_ops.matmul(a, b)
        want = matmul_ref(a, b)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("p,d,kdim", TLB_SHAPES + [(400, 1024, 96), (100, 1024, 160), (33, 70, 130)])
def test_pairwise_tlb_kernel_matches_plain(cuda_device, p, d, kdim):
    xi = torch.from_numpy(_normal(4, (p, d))).to(cuda_device)
    xj = torch.from_numpy(_normal(5, (p, d))).to(cuda_device)
    xj[0] = xi[0]  # a coincident pair
    v = torch.from_numpy(_basis(6, d, kdim)).to(cuda_device)
    before = tlb_ops.LAUNCHES
    got = tlb_ops.pairwise_tlb(xi, xj, v)
    torch.cuda.synchronize()
    assert tlb_ops.LAUNCHES == before + 1
    want = pairwise_tlb_ref(xi, xj, v)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)
    assert (got[0] == 1.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mq,mk,d", KNN_SHAPES + [(1, 1, 4), (2, 2, 4), (63, 63, 20), (97, 97, 33), (3000, 3000, 40)]
)
def test_pairwise_knn_kernel_matches_plain(cuda_device, mq, mk, d):
    x = torch.from_numpy(_normal(7, (mk, d))).to(cuda_device)
    before = knn_ops.LAUNCHES["pairwise_knn"]
    got_i, got_d2 = knn_ops.pairwise_knn_reduce(x[:mq].contiguous(), x, mk)
    torch.cuda.synchronize()
    assert knn_ops.LAUNCHES["pairwise_knn"] == before + 1
    want_i, want_d2 = pairwise_knn_ref(x[:mq], x, mk)
    np.testing.assert_array_equal(got_i.cpu().numpy(), want_i.cpu().numpy())
    np.testing.assert_allclose(got_d2.cpu().numpy(), want_d2.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_pairwise_knn_kernel_exact_tie_keeps_first(cuda_device):
    x = _normal(8, (200, 6))
    x[140] = x[3]
    x[150] = x[3]
    tx = torch.from_numpy(x).to(cuda_device)
    got_i, _ = knn_ops.pairwise_knn_reduce(tx, tx, 200)
    assert int(got_i[3]) == 140 and int(got_i[140]) == 3 and int(got_i[150]) == 3


def _d2_bound(xq, x):
    """float64 d2 and its float32 rounding bound, (mq, mk) each."""
    q64, x64 = xq.double(), x.double()
    sq_q, sq_x = (q64 * q64).sum(1), (x64 * x64).sum(1)
    d2 = sq_q[:, None] + sq_x[None, :] - 2.0 * q64 @ x64.T
    return d2, D2_ULPS * EPS32 * (sq_q[:, None] + sq_x[None, :])


@pytest.mark.cuda
@pytest.mark.parametrize("mq,mk,d", PR_SHAPES)
def test_pairwise_dbscan_kernel_matches_plain(cuda_device, mq, mk, d):
    x = torch.from_numpy(_normal(9, (mk, d))).to(cuda_device)
    xq = x[:mq].contiguous()
    eps2 = np.float32(2.25 if d < 20 else 49.0)
    before = knn_ops.LAUNCHES["pairwise_dbscan"]
    got_c, got_p = knn_ops.pairwise_dbscan_reduce(xq, x, mk, eps2)
    torch.cuda.synchronize()
    assert knn_ops.LAUNCHES["pairwise_dbscan"] == before + 1
    want_c, want_p = pairwise_dbscan_ref(xq, x, mk, eps2)
    assert got_p.shape == want_p.shape == (mq, -(-mk // 32))
    d2, bound = _d2_bound(xq, x)
    near = (d2 - float(eps2)).abs() <= bound
    got_bits = np.unpackbits(got_p.cpu().numpy().view(np.uint8), axis=1, bitorder="little")
    want_bits = np.unpackbits(want_p.cpu().numpy().view(np.uint8), axis=1, bitorder="little")
    assert not got_bits[:, mk:].any()
    far = ~near.cpu().numpy()
    np.testing.assert_array_equal(got_bits[:, :mk][far], want_bits[:, :mk][far])
    np.testing.assert_array_equal(got_c.cpu().numpy(), got_bits.sum(1))
    slack = near.sum(1).cpu().numpy()
    assert (np.abs(got_c.cpu().numpy() - want_c.cpu().numpy()) <= slack).all()


@pytest.mark.cuda
def test_pairwise_dbscan_kernel_excludes_columns_past_m(cuda_device):
    x = torch.from_numpy(_normal(11, (300, 4))).to(cuda_device)
    got_c, got_p = knn_ops.pairwise_dbscan_reduce(x, x, 200, np.float32(9.0))
    bits = np.unpackbits(got_p.cpu().numpy().view(np.uint8), axis=1, bitorder="little")
    assert not bits[:, 200:].any() and (bits[np.arange(200), np.arange(200)] == 1).all()
    np.testing.assert_array_equal(got_c.cpu().numpy(), bits.sum(1))


@pytest.mark.cuda
@pytest.mark.parametrize("mq,mk,d", PR_SHAPES)
def test_pairwise_kde_kernel_matches_plain(cuda_device, mq, mk, d):
    """sums + comps within rtol 2e-5 (float32 sums in another order) plus
    the d2 expansion's rounding bound times inv_two_h2, relative: the two
    sides round each d2 differently before the exponential."""
    x = torch.from_numpy(_normal(10, (mk, d))).to(cuda_device)
    xq = torch.from_numpy(_normal(12, (mq, d))).to(cuda_device) if mq == 97 else x[:mq].contiguous()
    inv = np.float32(0.5 if d < 20 else 0.02)
    before = knn_ops.LAUNCHES["pairwise_kde"]
    got_s, got_c = knn_ops.pairwise_kde_reduce(xq, x, mk - 1, inv)
    torch.cuda.synchronize()
    assert knn_ops.LAUNCHES["pairwise_kde"] == before + 1
    want, _ = pairwise_kde_ref(xq, x, mk - 1, inv)
    got = got_s.double() + got_c.double()
    _, bound = _d2_bound(xq, x[: mk - 1]) if mk > 1 else (None, torch.zeros((mq, 1), device=x.device))
    tol = want.double() * (2e-5 + float(inv) * bound.max(dim=1).values) + 1e-30
    assert ((got - want.double()).abs() <= tol).all()
