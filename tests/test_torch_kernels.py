"""Kernels K1-K3 of the PyTorch port (K4 and K5:
``tests/test_torch_pairwise_reduce.py``), and the dispatch rule of all five.

On the CPU: each kernel's plain PyTorch version against the JAX package's
Pallas kernel in interpret mode, on that package's own sweep shapes
(``tests/test_kernels.py``), with inputs made by numpy from a seed.

The kernels themselves run only on a CUDA GPU:
``tests/test_torch_kernels_cuda.py`` holds them against these plain
versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul.matmul import matmul_pallas
from repro.kernels.pairwise_reduce.pairwise_reduce import pairwise_knn_pallas
from repro.kernels.pairwise_tlb.pairwise_tlb import pairwise_tlb_pallas
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.pairwise_reduce import ops as knn_ops
from repro_torch.kernels.pairwise_tlb import ops as tlb_ops

# the reference sweep's shapes and interpret-mode blocks
MM_SHAPES = [(32, 32, 32), (48, 16, 64), (33, 17, 19), (5, 40, 3), (16, 1, 16), (1, 16, 1)]
MM_BLOCKS = dict(block_m=16, block_n=16, block_k=16)
TLB_SHAPES = [(16, 32, 16), (32, 64, 48), (19, 33, 21), (4, 8, 1), (1, 16, 16)]
TLB_BLOCKS = dict(block_p=16, block_k=16)
KNN_SHAPES = [(32, 32, 8), (48, 80, 16), (33, 61, 7), (1, 16, 4), (3, 3, 2)]
KNN_BLOCKS = dict(block_q=16, block_k=32)

# float32: both sides sum the same products in another order (1e-5, the
# reference sweep's own tolerance); bfloat16: one rounding of the output
F32_TOL = 1e-5
BF16_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(a, dtype):
    """One float32 numpy array as a JAX and a torch array of ``dtype``
    (both round float32 to bfloat16 to nearest even)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else jnp.asarray(t, jnp.float32))


def _basis(seed, d, k):
    return np.linalg.qr(_normal(seed, (d, d)))[0][:, :k].astype(np.float32)


# ------------------------------------------------ plain versions vs Pallas


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_matches_pallas(m, k, n, dtype):
    ja, ta = _both(_normal(0, (m, k)), dtype)
    jb, tb = _both(_normal(1, (k, n)), dtype)
    want = matmul_pallas(ja, jb, interpret=True, **MM_BLOCKS)
    got = mm_ops.matmul(ta, tb)
    assert got.dtype == ta.dtype and got.shape == (m, n)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_matmul_plain_reads_transposed_views():
    c = _normal(2, (40, 24))
    y = _normal(3, (40, 5))
    tc = torch.from_numpy(c)
    want = matmul_pallas(jnp.asarray(c.T), jnp.asarray(y), interpret=True, **MM_BLOCKS)
    got = mm_ops.matmul(tc.T, torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("p,d,kdim", TLB_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pairwise_tlb_plain_matches_pallas(p, d, kdim, dtype):
    jxi, txi = _both(_normal(4, (p, d)), dtype)
    jxj, txj = _both(_normal(5, (p, d)), dtype)
    jv, tv = _both(_basis(6, d, kdim), dtype)
    want = pairwise_tlb_pallas(jxi, jxj, jv, interpret=True, **TLB_BLOCKS)
    got = tlb_ops.pairwise_tlb(txi, txj, tv)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_pairwise_tlb_plain_coincident_pair_is_one():
    x = torch.ones((8, 16))
    got = tlb_ops.pairwise_tlb(x, x, torch.eye(16)[:, :8].contiguous())
    np.testing.assert_array_equal(got.numpy(), 1.0)


@pytest.mark.parametrize("mq,mk,d", KNN_SHAPES)
def test_pairwise_knn_plain_matches_pallas(mq, mk, d):
    x = _normal(7, (mk, d))
    want_i, want_d2 = pairwise_knn_pallas(
        jnp.asarray(x[:mq]), jnp.asarray(x), mk, interpret=True, **KNN_BLOCKS
    )
    tx = torch.from_numpy(x)
    got_i, got_d2 = knn_ops.pairwise_knn_reduce(tx[:mq], tx, mk)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d2.numpy(), np.asarray(want_d2), rtol=1e-5, atol=1e-5)


def test_pairwise_knn_plain_tie_break_matches_pallas():
    """First occurrence wins an exact tie across tiles."""
    x = _normal(8, (70, 6))
    x[40] = x[3]
    x[41] = x[3] + 1e-4
    want_i, _ = pairwise_knn_pallas(jnp.asarray(x), jnp.asarray(x), 70, interpret=True, **KNN_BLOCKS)
    tx = torch.from_numpy(x)
    got_i, _ = knn_ops.pairwise_knn_reduce(tx, tx, 70)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize(
    "call",
    [
        lambda t: mm_ops.matmul(t, t),
        lambda t: tlb_ops.pairwise_tlb(t, t, t),
        lambda t: knn_ops.pairwise_knn_reduce(t, t, 4),
        lambda t: knn_ops.pairwise_dbscan_reduce(t, t, 4, 1.0),
        lambda t: knn_ops.pairwise_kde_reduce(t, t, 4, 0.5),
    ],
    ids=["matmul", "pairwise_tlb", "pairwise_knn", "pairwise_dbscan", "pairwise_kde"],
)
def test_dispatch_raises_off_cpu_and_cuda(call):
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    never computed some other way."""
    with pytest.raises(ValueError):
        call(torch.empty((4, 4), device="meta"))
