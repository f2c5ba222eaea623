#!/usr/bin/env python3
"""Drive the PyTorch port of DROP on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a host with a CUDA GPU, ``nvcc`` and the
port's dependencies (torch, numpy, scipy). It needs one card and exits
non-zero, printing no result, on a host without CUDA or when any check
fails. Phases:

0. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every kernel from ``src/repro_torch/kernels/csrc``.
1. Each kernel (K1 matmul, K2 pairwise TLB, K3 1-NN, K4 DBSCAN eps-ball,
   K5 Gaussian KDE) against its plain PyTorch version on the card, on the
   JAX package's sweep shapes (ragged and degenerate ones included, bf16
   for K1, ragged widths around the 32-bit word for K4/K5) and on the main
   paths' shapes.
2. Main path A, ``ecg_like(8000, 1024)`` (StarLightCurves scale): ``drop``
   with the full schedule on the card, a timed ``drop`` that Eq. 2 stops,
   ``transform`` and ``nearest_neighbors`` on the card; then the full
   schedule on the card and on the CPU in lockstep (same rows, pairs and k
   at every iteration without a near-tie; TLB within tolerance) and 1-NN
   on the card against the CPU.
3. Main path B, ``mnist_like(70000, 28)`` (MNIST's rows and width): ``drop``
   and 1-NN on the card, the basis' TLB on 2,000 fresh pairs, and 1-NN on
   512 random rows against float64 brute force; then one full launch each
   of K4 and K5 on the 70,000 x k reduced data, 512 random query rows held
   against the plain version.
4. Main path C, the paper's §4.4 workload on path A's data:
   ``WorkloadOptimizer`` over PCA (DROP), FFT, PAA, DWT and JL for the
   knn, dbscan and kde downstreams, every method executed on the card.
   Per method: the basis' TLB on 2,000 fresh pairs, and the baselines' k
   against the same host numpy code's CPU run. Then DBSCAN and KDE on the
   PCA-reduced data at a working eps and bandwidth, card against the CPU.
5. Each kernel timed beside its plain version, its bound and (K1)
   ``torch.matmul``: K1-K3 at the largest shape path A gave them, K4 and
   K5 at path C's 8000 x 8000 at DROP's k and at path B's full shape; then one JSON line listing the kernels with their
   launches on each main path, and the final ``{"ok": true, ...}`` line.

The launch counts are each dispatcher's own ``LAUNCHES``, set to 0 just
before a main path (path A: the timed ``drop``, ``transform`` and
``nearest_neighbors``; path B: ``drop``, ``transform`` and
``nearest_neighbors``; path C: the three ``optimize`` calls) and read just
after it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
TARGET_TLB = 0.98

# float32 kernels sum in another order than the plain versions: an error
# bound of F32_ULPS float32 epsilons per sqrt(contraction length), relative
# to the largest output (a wrong index or a missed tile is O(1) of it)
EPS32 = 2.0**-23
F32_ULPS = 8
BF16_TOL = 2.0**-7  # one bfloat16 rounding of the output, relative
TLB_KERNEL_TOL = 1e-5  # K2 outputs lie in [0, 1]
TLB_TOL = 1e-3  # drop's TLB estimates, card vs CPU (tests/test_torch_drop.py)
# a TLB probe mean this close to the target may fall either side of it on
# the card and on the CPU: their bases differ by float32 rounding, which
# moves a mean over <= 800 pairs by ~1e-5
TIE_TOL = 1e-4
# 1-NN indices are compared on rows whose plain gap between the nearest and
# the second-nearest squared distance exceeds this many float32 epsilons of
# ||q||^2 + ||x||^2, the size of the terms the d2 expansion cancels
KNN_GAP_ULPS = 64

# K4 flags a pair whose float64 d2 lies within this many float32 epsilons
# of ||q||^2 + ||x||^2 of eps^2: it may fall either side on two devices
D2_ULPS = 64
# K5 densities: float32 sums in another order (rtol), plus the d2
# expansion's rounding bound (D2_ULPS) times inv_two_h2, relative: the two
# sides round each d2 differently before the exponential
KDE_RTOL = 2e-5

# the card the bounds are for, as torch.cuda.get_device_name names it, and its
# HBM bytes/s and float32 FLOP/s outside the tensor cores (H100 SXM data sheet)
CARD = "NVIDIA H100 80GB HBM3"
PEAKS = ("H100 SXM", 3.35e12, 67e12)
# exponentials per second on the special function units: 16 exp2 results
# per clock per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) x 132 SMs x 1.98 GHz, the boost clock
# at which 132 SMs x 128 FP32 lanes x 2 give the data sheet's 67 TFLOP/s
SFU_EXP_PER_S = 16 * 132 * 1.98e9


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def bound_ms(nbytes: float, flops: float, exps: float = 0.0) -> tuple[float, str]:
    """The least time for the work: bytes over HBM bandwidth, or float32
    operations over the FP32 rate, or exponentials over the SFU rate."""
    t_bytes = nbytes / PEAKS[1] * 1e3
    t_ops = max(flops / PEAKS[2], exps / SFU_EXP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def eps_for(x, quantile: float = 0.005, probe: int = 512, seed: int = 0) -> tuple[float, float]:
    """An eps giving about ``quantile`` of pairs as neighbors, and the median
    distance, from sampled rows (``benchmarks/bench_pairwise_analytics.py``
    ``_eps_for``'s rule: neighbor sets small but non-empty)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s = x[rng.integers(0, x.shape[0], size=min(probe, x.shape[0]))]
    d2 = (s * s).sum(1)[:, None] + (s * s).sum(1)[None, :] - 2.0 * s @ s.T
    vals = np.sqrt(np.maximum(d2[np.triu_indices(s.shape[0], 1)], 0.0))
    return float(np.quantile(vals, quantile)), float(np.median(vals))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this runs on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        return run(torch)
    except CheckFailed as exc:
        print(f"chip_smoke: CHECK FAILED: {exc}", file=sys.stderr)
        return 1


def run(torch) -> int:
    import numpy as np

    import repro_torch.analytics.knn as knn_mod
    import repro_torch.core.tlb as tlb_mod
    from repro_torch.analytics import dbscan, gaussian_kde, pairwise_dbscan
    from repro_torch.core import DropConfig, PcaDropReducer, drop, reduce
    from repro_torch.core.tlb import prefix_tlb_table, sample_pairs
    from repro_torch.data import ecg_like, mnist_like
    from repro_torch.kernels import _build
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
    from repro_torch.pipeline import WorkloadOptimizer
    from repro_torch.utils import resolve_device

    t_start = time.perf_counter()
    dev = resolve_device("cuda:0")

    # ---------------------------------------------------------- 0. card, build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    check(name == CARD, f"the bounds hold the peak rates of {CARD} ({PEAKS[0]}), not of {name}")
    print(f"[0] device {name}, capability {torch.cuda.get_device_capability(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"peaks from the {PEAKS[0]} data sheet: {PEAKS[1] / 1e12} TB/s, {PEAKS[2] / 1e12} TFLOP/s f32")
    build_s = _build.build_all()
    print(f"[0] kernel build: {build_s:.2f} s (0 = already built)")
    for stem, log in sorted(_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[0]   {stem}: {line.strip()}")

    gen = np.random.default_rng(SEED)

    def normal(*shape):
        return torch.from_numpy(gen.standard_normal(shape, dtype=np.float32)).to(dev)

    def sync_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    # ------------------------------------------------------ 1. kernel checks
    errs = {"matmul": 0.0, "matmul_bf16": 0.0, "pairwise_tlb": 0.0, "pairwise_knn": 0.0,
            "pairwise_dbscan": 0.0, "pairwise_kde": 0.0}

    def check_matmul(a, b, label):
        got = mm_ops.matmul(a, b)
        want = matmul_ref(a, b)
        torch.cuda.synchronize()
        k = a.shape[1]
        scale = max(float(want.float().abs().max()), 1.0)
        err = float((got.float() - want.float()).abs().max())
        if a.dtype == torch.bfloat16:
            tol = BF16_TOL * scale
            errs["matmul_bf16"] = max(errs["matmul_bf16"], err)
        else:
            tol = F32_ULPS * EPS32 * max(k, 1) ** 0.5 * scale
            errs["matmul"] = max(errs["matmul"], err)
        check(got.dtype == a.dtype and got.shape == want.shape, f"K1 {label}: dtype/shape")
        check(err <= tol, f"K1 {label}: max |err| {err:.3e} > {tol:.3e}")

    mm_cases = [(32, 32, 32), (48, 16, 64), (33, 17, 19), (5, 40, 3), (16, 1, 16), (1, 16, 1)]
    for m, k, n in mm_cases:
        for dtype in (torch.float32, torch.bfloat16):
            check_matmul(normal(m, k).to(dtype), normal(k, n).to(dtype), f"sweep {m}x{k}x{n} {dtype}")
    c = normal(8000, 1024)
    y = normal(8000, 85)
    check_matmul(c, normal(1024, 85), "C @ Omega 8000x1024x85")
    check_matmul(c.T, y, "C^T @ Y (strided view) 1024x8000x85")
    check_matmul(y.T, c, "Q^T @ C (strided view) 85x8000x1024")
    check_matmul(normal(8001, 1023), normal(1023, 37), "ragged 8001x1023x37")
    check_matmul(c.to(torch.bfloat16), normal(1024, 85).to(torch.bfloat16), "bf16 8000x1024x85")
    del c, y
    print(f"[1] K1 matmul: {len(mm_cases) * 2 + 5} cases agree with the plain version "
          f"(max |err| f32 {errs['matmul']:.3e}, bf16 {errs['matmul_bf16']:.3e})")

    def check_tlb(p, d, kdim, label):
        xi, xj = normal(p, d), normal(p, d)
        xj[0] = xi[0]  # a coincident pair
        v = torch.linalg.qr(normal(d, max(d, kdim)))[0][:, :kdim].contiguous()
        got = tlb_ops.pairwise_tlb(xi, xj, v)
        want = pairwise_tlb_ref(xi, xj, v)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs["pairwise_tlb"] = max(errs["pairwise_tlb"], err)
        check(err <= TLB_KERNEL_TOL, f"K2 {label}: max |err| {err:.3e} > {TLB_KERNEL_TOL}")
        check(bool((got[0] == 1.0).all()), f"K2 {label}: coincident pair is not 1")

    tlb_cases = [(16, 32, 16), (32, 64, 48), (19, 33, 21), (4, 8, 1), (1, 16, 16),
                 (100, 1024, 85), (400, 1024, 96), (800, 784, 40), (33, 1000, 130)]
    for p, d, kdim in tlb_cases:
        check_tlb(p, d, kdim, f"{p}x{d}x{kdim}")
    print(f"[1] K2 pairwise_tlb: {len(tlb_cases)} cases agree with the plain version "
          f"(max |err| {errs['pairwise_tlb']:.3e})")

    def knn_clear_rows(xq, x, m):
        """Rows whose plain float64 nearest and second-nearest squared
        distances are apart by more than the d2 expansion's rounding."""
        q64, x64 = xq.double(), x[:m].double()
        sq_q, sq_x = (q64 * q64).sum(1), (x64 * x64).sum(1)
        d2 = sq_q[:, None] + sq_x[None, :] - 2.0 * q64 @ x64.T
        rows = torch.arange(xq.shape[0], device=dev)
        if m > 1:
            d2[rows, rows] = torch.inf
        if m < 3:
            return torch.ones(xq.shape[0], dtype=torch.bool, device=dev)
        two, idx = torch.topk(d2, 2, dim=1, largest=False)
        tol = KNN_GAP_ULPS * EPS32 * (sq_q + sq_x[idx[:, 0]])
        return (two[:, 1] - two[:, 0]) > tol

    def brute_force_nn(xt, rows, picks):
        """Float64 brute-force nearest other row for ``rows`` of ``xt``.
        Returns (true index, excess, clear): ``excess`` is how much farther
        each pick lies than the true nearest row, as a fraction of the
        float32 rounding bound of the d2 expansion (KNN_GAP_ULPS epsilons
        of ||q||^2 + ||x||^2); ``clear`` marks rows whose second-nearest
        row is farther than that bound, where the pick must be exact."""
        x64 = torch.from_numpy(xt).to(dev).double()
        r = torch.from_numpy(rows).to(dev)
        ar = torch.arange(len(rows), device=dev)
        sq = (x64 * x64).sum(1)
        d2 = sq[r][:, None] + sq[None, :] - 2.0 * x64[r] @ x64.T
        d2[ar, r] = torch.inf
        two, idx = torch.topk(d2, 2, dim=1, largest=False)
        bound = KNN_GAP_ULPS * EPS32 * (sq[r] + sq[idx[:, 0]])
        picked = d2[ar, torch.from_numpy(picks.astype(np.int64)).to(dev)]
        return (idx[:, 0].cpu().numpy(),
                ((picked - two[:, 0]) / bound).cpu().numpy(),
                ((two[:, 1] - two[:, 0]) > bound).cpu().numpy())

    def check_knn(xq, x, m, label):
        got_i, got_d2 = knn_ops.pairwise_knn_reduce(xq, x, m)
        want_i, want_d2 = pairwise_knn_ref(xq, x, m)
        torch.cuda.synchronize()
        clear = knn_clear_rows(xq, x, m)
        bad = int((got_i != want_i)[clear].sum())
        check(bad == 0, f"K3 {label}: {bad} index mismatches on rows with margin")
        finite = torch.isfinite(want_d2)
        check(bool((torch.isfinite(got_d2) == finite).all()), f"K3 {label}: inf pattern differs")
        scale = max(float((x * x).sum(1).max()), 1.0)
        err = float((got_d2[finite] - want_d2[finite]).abs().max()) if finite.any() else 0.0
        errs["pairwise_knn"] = max(errs["pairwise_knn"], err)
        check(err <= KNN_GAP_ULPS * EPS32 * 2 * scale, f"K3 {label}: d2 |err| {err:.3e}")
        return int((~clear).sum())

    knn_cases = [(32, 32, 8), (48, 80, 16), (33, 61, 7), (1, 16, 4), (3, 3, 2),
                 (1, 1, 4), (2, 2, 4), (63, 63, 20), (97, 97, 33), (8000, 8000, 32)]
    near = 0
    for mq, mk, d in knn_cases:
        x = normal(mk, d)
        near += check_knn(x[:mq].contiguous(), x, mk, f"{mq}x{mk}x{d}")
    xt = normal(200, 6)
    xt[140] = xt[3]
    xt[150] = xt[3]
    got_i, _ = knn_ops.pairwise_knn_reduce(xt, xt, 200)
    check((int(got_i[3]), int(got_i[140]), int(got_i[150])) == (140, 3, 3),
          "K3: an exact tie does not keep the first occurrence")
    one_i, one_d2 = knn_ops.pairwise_knn_reduce(xt[:1], xt[:1], 1)
    check(int(one_i[0]) == 0 and bool(torch.isinf(one_d2[0])), "K3: m=1 does not return itself")
    print(f"[1] K3 pairwise_knn: {len(knn_cases) + 2} cases agree with the plain version "
          f"({near} near-tie rows skipped; max |d2 err| {errs['pairwise_knn']:.3e})")

    def near_eps(xq, x, m, eps2):
        """Pairs (query, column < m) whose float64 d2 lies within the d2
        expansion's float32 rounding of eps2: either device may flag them."""
        q64, x64 = xq.double(), x[:m].double()
        sq_q, sq_x = (q64 * q64).sum(1), (x64 * x64).sum(1)
        d2 = sq_q[:, None] + sq_x[None, :] - 2.0 * q64 @ x64.T
        return (d2 - float(eps2)).abs() <= D2_ULPS * EPS32 * (sq_q[:, None] + sq_x[None, :])

    def bits(packed):
        shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
        return ((packed.view(torch.int32)[:, :, None] >> shifts) & 1).reshape(packed.shape[0], -1)

    def compare_dbscan(got_c, got_p, want_c, want_p, near, mk, label):
        """K4 against the plain version: equal words off the flagged pairs,
        no bit at or past column m (tail words included), counts that are
        the words' popcounts and within the row's flagged pairs of the
        plain counts. Returns (flagged pairs, bits that differ)."""
        check(got_p.shape == want_p.shape == (got_c.shape[0], -(-mk // 32)),
              f"K4 {label}: packed shape {tuple(got_p.shape)}")
        gb, wb = bits(got_p), bits(want_p)
        m = near.shape[1]
        check(not bool(gb[:, m:].any()), f"K4 {label}: bits set at or past column m")
        differ = gb[:, :m] != wb[:, :m]
        off = int((differ & ~near).sum())
        check(off == 0, f"K4 {label}: {off} neighbor bits differ off the eps boundary")
        check(bool((got_c == gb.sum(1)).all()), f"K4 {label}: counts are not the words' popcounts")
        dc = (got_c.long() - want_c.long()).abs()
        check(bool((dc <= near.sum(1)).all()), f"K4 {label}: counts differ beyond the flagged pairs")
        errs["pairwise_dbscan"] = max(errs["pairwise_dbscan"], float(dc.max()) if dc.numel() else 0.0)
        return int(near.sum()), int(differ.sum())

    def compare_kde(got_s, got_c, want_s, xq, x, m, inv, label):
        """K5 against the plain version, per row: |got - want| <= want *
        (KDE_RTOL + inv * the largest d2 rounding bound of the row)."""
        got, want = got_s.double() + got_c.double(), want_s.double()
        err = (got - want).abs()
        if m > 0:
            sq_q = (xq.double() ** 2).sum(1)
            bmax = D2_ULPS * EPS32 * (sq_q + float((x[:m].double() ** 2).sum(1).max()))
            tol = want * (KDE_RTOL + float(inv) * bmax)
        else:
            tol = torch.zeros_like(want)
        check(bool((err <= tol).all()), f"K5 {label}: max |err| {float(err.max()):.3e} beyond tolerance")
        errs["pairwise_kde"] = max(errs["pairwise_kde"], float(err.max()) if err.numel() else 0.0)
        return float((err / want.clamp_min(1e-300)).max()) if err.numel() else 0.0

    # the reference sweep (eps 1.5, inv_two_h2 0.5), ragged mk around the
    # 32-bit word, columns past m, separate queries (K5), a shape whose few
    # row blocks split the column tiles, and path C's 8000 x 8000 at DROP's k
    pr_cases = [(32, 32, 8, 32), (48, 80, 16, 80), (33, 61, 7, 61), (1, 16, 4, 16), (3, 3, 2, 3),
                (31, 31, 5, 31), (33, 33, 5, 33), (63, 63, 6, 63), (97, 97, 3, 97),
                (40, 70, 4, 50), (100, 5000, 16, 5000), (8000, 8000, 42, 8000)]
    flagged = 0
    worst_rel = 0.0
    for mq, mk, d, m in pr_cases:
        x = normal(mk, d)
        eps2 = np.float32(2.25 if d < 16 else 1.4 * d)  # d2 ~ 2d: a few percent are neighbors
        inv = np.float32(0.5 if d < 16 else 1.0 / (2.0 * d))
        label = f"{mq}x{mk}x{d} m={m}"
        xq = x[:mq].contiguous()
        got_c, got_p = knn_ops.pairwise_dbscan_reduce(xq, x, m, eps2)
        want_c, want_p = pairwise_dbscan_ref(xq, x, m, eps2)
        torch.cuda.synchronize()
        flagged += compare_dbscan(got_c, got_p, want_c, want_p, near_eps(xq, x, m, eps2), mk, label)[0]
        if mq == 97:
            xq = normal(mq, d)  # queries that are not dataset rows
        got_s, got_k = knn_ops.pairwise_kde_reduce(xq, x, m, inv)
        want_s, _ = pairwise_kde_ref(xq, x, m, inv)
        torch.cuda.synchronize()
        worst_rel = max(worst_rel, compare_kde(got_s, got_k, want_s, xq, x, m, inv, label))
    print(f"[1] K4 pairwise_dbscan: {len(pr_cases)} cases agree with the plain version "
          f"({flagged} pairs within rounding of eps2; max |count err| {errs['pairwise_dbscan']:.0f})")
    print(f"[1] K5 pairwise_kde: {len(pr_cases)} cases agree with the plain version "
          f"(max |err| {errs['pairwise_kde']:.3e}, max relative {worst_rel:.3e}; "
          f"tolerance rtol {KDE_RTOL} + inv_two_h2 x the d2 rounding bound)")

    # record every kernel call's operands on the main path, to time the
    # kernels there afterwards; the dispatchers are wrapped, not changed
    calls = {"matmul": [], "pairwise_tlb": [], "pairwise_knn": [], "pairwise_dbscan": [],
             "pairwise_kde": []}

    def recording(module, attr, log):
        inner = getattr(module, attr)

        def wrapper(*args):
            log.append([(tuple(a.shape), tuple(a.stride()), a.dtype) if torch.is_tensor(a) else a
                        for a in args])
            return inner(*args)

        setattr(module, attr, wrapper)
        return lambda: setattr(module, attr, inner)

    restore = [
        recording(mm_ops, "matmul", calls["matmul"]),
        recording(tlb_ops, "pairwise_tlb", calls["pairwise_tlb"]),
        recording(knn_ops, "pairwise_knn_reduce", calls["pairwise_knn"]),
        recording(knn_ops, "pairwise_dbscan_reduce", calls["pairwise_dbscan"]),
        recording(knn_ops, "pairwise_kde_reduce", calls["pairwise_kde"]),
    ]

    def reset_counts():
        mm_ops.LAUNCHES = 0
        tlb_ops.LAUNCHES = 0
        for kname in knn_ops.LAUNCHES:
            knn_ops.LAUNCHES[kname] = 0
        for log in calls.values():
            log.clear()

    def read_counts():
        return {"matmul": mm_ops.LAUNCHES, "pairwise_tlb": tlb_ops.LAUNCHES, **knn_ops.LAUNCHES}

    def lockstep(x, cfg):
        """A card and a CPU reducer stepped side by side. After each step the
        card reducer takes the CPU one's host state (RNG streams, the Ω
        generator, the rank bound, the carried points), so each iteration
        compares the same computation on the two devices from the same
        inputs. Returns (card record, CPU record, distance to the target of
        the nearest value the CPU's binary search compared with it) per
        iteration: each pair-doubling step's CI bounds and each probe's
        final mean. A value that close may fall either side of the target
        on either device."""
        decisive = []
        inner_ci = tlb_mod.gaussian_ci
        inner_at_k = tlb_mod.TLBEstimator.estimate_at_k

        def recording_ci(vals, confidence):
            out = inner_ci(vals, confidence)
            decisive.extend(out[1:])
            return out

        def recording_at_k(self, k_, target, **kw):
            est = inner_at_k(self, k_, target, **kw)
            decisive.append(est.mean)
            return est

        tlb_mod.gaussian_ci = recording_ci
        tlb_mod.TLBEstimator.estimate_at_k = recording_at_k
        try:
            card_r = PcaDropReducer(x, cfg, device="cuda")
            cpu_r = PcaDropReducer(x, cfg, device="cpu")
            steps_, more = [], True
            while more:
                card_r.step()
                decisive.clear()
                more = cpu_r.step()
                near_ = min((abs(v_ - cfg.target_tlb) for v_ in decisive), default=1.0)
                steps_.append((card_r.records[-1], cpu_r.records[-1], near_))
                card_r._rng.bit_generator.state = cpu_r._rng.bit_generator.state
                card_r._pair_rng.bit_generator.state = cpu_r._pair_rng.bit_generator.state
                card_r._omega_gen.set_state(cpu_r._omega_gen.get_state())
                card_r.prev_k = cpu_r.prev_k
                card_r._hard_points = cpu_r._hard_points
        finally:
            tlb_mod.gaussian_ci = inner_ci
            tlb_mod.TLBEstimator.estimate_at_k = inner_at_k
        return steps_

    # ------------------------------------------------------- 2. main path A
    t0 = time.perf_counter()
    xa, labels_a = ecg_like(8000, 1024, seed=SEED)
    print(f"[2] path A data ecg_like(8000, 1024): {time.perf_counter() - t0:.1f} s")
    fixed = DropConfig(target_tlb=TARGET_TLB, min_iterations=99, seed=SEED)

    t0 = time.perf_counter()
    gpu = drop(xa, fixed, device="cuda")
    fixed_gpu_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    timed = drop(xa, DropConfig(target_tlb=TARGET_TLB, seed=SEED), device="cuda")
    timed_s = time.perf_counter() - t0
    xta = timed.transform(xa)
    t0 = time.perf_counter()
    nn_gpu = knn_mod.nearest_neighbors(xta, device="cuda")
    knn_a_s = time.perf_counter() - t0
    launches_a = read_counts()
    shapes_a = {k_: list(v_) for k_, v_ in calls.items()}

    t0 = time.perf_counter()
    steps = lockstep(xa, fixed)
    print(f"[2] full schedule: card {fixed_gpu_s:.2f} s alone; card and CPU in lockstep "
          f"{time.perf_counter() - t0:.2f} s")
    dtlb, ties, differ = 0.0, 0, []
    for g, c_, near in steps:
        tie = near <= TIE_TOL
        ties += tie
        print(f"[2]   iter {g.i}: rows {g.sample_size}/{c_.sample_size} k {g.k}/{c_.k} "
              f"pairs {g.pairs_used}/{c_.pairs_used} tlb {g.tlb_estimate:.6f}/{c_.tlb_estimate:.6f} "
              f"nearest decisive TLB to target {near:.1e}{' (near-tie)' if tie else ''}")
        check(g.sample_size == c_.sample_size, f"path A iter {g.i}: sample sizes differ")
        same = (g.k, g.pairs_used) == (c_.k, c_.pairs_used)
        check(same or tie, f"path A iter {g.i}: k or pairs differ card vs CPU without a near-tie")
        if same:
            dtlb = max(dtlb, abs(g.tlb_estimate - c_.tlb_estimate))
        else:
            differ.append(g.i)
    check(len(steps) == len(gpu.iterations), "path A: iteration counts differ")
    check(dtlb < TLB_TOL, f"path A: TLB card vs CPU differs by {dtlb:.2e} >= {TLB_TOL}")
    # the card's own run shares the CPU's state until the first near-tie
    cpu_records = [c_ for _, c_, _ in steps]
    first = next((r.i for r, c_ in zip(gpu.iterations, cpu_records)
                  if (r.k, r.pairs_used) != (c_.k, c_.pairs_used)), None)
    check(first is None or steps[first][2] <= TIE_TOL,
          f"path A: the card's own run leaves the CPU's at iteration {first} without a near-tie")
    print(f"[2] card vs CPU: {len(steps) - len(differ)} of {len(steps)} iterations identical in "
          f"rows, pairs and k (max |dTLB| {dtlb:.2e}); {ties} near-tie iterations, k differs at "
          f"{differ}; the card's own run "
          f"{'matches the CPU run throughout' if first is None else f'follows the CPU run until iteration {first}'} "
          f"(final k {gpu.k} vs {cpu_records[-1].k})")

    check(timed.satisfied, "path A: the timed drop found no TLB-preserving basis")
    print(f"[2] timed drop (Eq. 2): {len(timed.iterations)} iterations, "
          f"{timed.total_rows_processed} rows processed, k {timed.k}, "
          f"TLB {timed.tlb_estimate:.4f}, R {timed.runtime_s:.4f} s (wall {timed_s:.4f} s)")
    check(xta.shape == (8000, timed.k) and np.isfinite(xta).all(), "path A: bad transform")
    nn_cpu = knn_mod.nearest_neighbors(xta, device="cpu")
    xt_dev = torch.from_numpy(xta).to(dev)
    clear = knn_clear_rows(xt_dev, xt_dev, xt_dev.shape[0]).cpu().numpy()
    mism = int((nn_gpu != nn_cpu).sum())
    mism_clear = int((nn_gpu != nn_cpu)[clear].sum())
    _, excess_a, _ = brute_force_nn(xta, np.arange(xta.shape[0]), nn_gpu)
    acc = float((labels_a[nn_gpu] == labels_a).mean())
    print(f"[2] 1-NN on the card: {knn_a_s * 1e3:.2f} ms (host clock, transfers included); "
          f"card vs CPU: {mism} mismatches, {mism_clear} on {int(clear.sum())} rows with margin; "
          f"worst pick's excess d2 vs float64 brute force {float(excess_a.max()):.3f} of the "
          f"rounding bound; label agreement {acc:.4f}")
    check(mism_clear == 0, f"path A: 1-NN card vs CPU: {mism_clear} mismatches on rows with margin")
    check(bool((excess_a <= 1.0).all()), "path A: a 1-NN pick is farther than the rounding bound")
    print(f"[2] launches on path A: {launches_a}")

    # ------------------------------------------------------- 3. main path B
    t0 = time.perf_counter()
    xb, labels_b = mnist_like(m=70000, side=28, seed=SEED)
    print(f"[3] path B data mnist_like(70000, 28): {time.perf_counter() - t0:.1f} s")
    reset_counts()
    t0 = time.perf_counter()
    res_b = drop(xb, DropConfig(target_tlb=TARGET_TLB, seed=SEED), device="cuda")
    drop_b_s = time.perf_counter() - t0
    xtb = res_b.transform(xb)
    t0 = time.perf_counter()
    nn_b = knn_mod.nearest_neighbors(xtb, device="cuda")
    knn_b_s = time.perf_counter() - t0
    launches_b = read_counts()
    print(f"[3] drop: {len(res_b.iterations)} iterations, {res_b.total_rows_processed} rows, "
          f"k {res_b.k}, TLB {res_b.tlb_estimate:.4f}, R {res_b.runtime_s:.3f} s (wall {drop_b_s:.3f} s); "
          f"1-NN {knn_b_s * 1e3:.1f} ms")
    check(res_b.satisfied, "path B: drop is not satisfied")
    pairs = torch.from_numpy(sample_pairs(70000, 2000, np.random.default_rng(12345)).astype(np.int64)).to(dev)
    xb_dev = torch.from_numpy(xb).to(dev)
    v_b = torch.from_numpy(np.ascontiguousarray(res_b.v)).to(dev)
    fresh = float(prefix_tlb_table(xb_dev[pairs[:, 0]], xb_dev[pairs[:, 1]], v_b)[:, -1].mean())
    print(f"[3] TLB of the basis on 2,000 fresh pairs (plain version): {fresh:.4f}")
    check(fresh >= TARGET_TLB - 0.01, f"path B: fresh-pair TLB {fresh:.4f} < {TARGET_TLB - 0.01}")
    rows = np.random.default_rng(SEED + 1).choice(70000, 512, replace=False)
    got_b = nn_b[rows]
    brute, excess, clear_b = brute_force_nn(xtb, rows, got_b)
    mism_b = int((got_b != brute)[clear_b].sum())
    print(f"[3] 1-NN on 512 random rows vs float64 brute force: {int((got_b != brute).sum())} index "
          f"mismatches, {mism_b} on {int(clear_b.sum())} rows with margin; worst pick's excess d2 "
          f"{float(excess.max()):.3f} of the rounding bound; label agreement "
          f"{float((labels_b[nn_b] == labels_b).mean()):.4f}")
    check(mism_b == 0, f"path B: {mism_b} 1-NN mismatches vs brute force on rows with margin")
    check(bool((excess <= 1.0).all()), "path B: a 1-NN pick is farther than the rounding bound")
    print(f"[3] launches on path B: {launches_b}")
    del xb_dev

    def event_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out_ = fn()
        end.record()
        torch.cuda.synchronize()
        return out_, start.elapsed_time(end)

    # K4 and K5 at scale: one full launch each on the 70,000 x k reduced data
    eps_b, h_b = eps_for(xtb)
    eps2_b = np.float32(eps_b * eps_b)
    inv_b = np.float32(1.0 / (2.0 * h_b * h_b))
    xtb_dev = torch.from_numpy(np.ascontiguousarray(xtb)).to(dev)
    mb = xtb_dev.shape[0]
    (counts_b, packed_b), dbscan_b_ms = event_ms(
        lambda: knn_ops.pairwise_dbscan_reduce(xtb_dev, xtb_dev, mb, eps2_b))
    (sums_b, comps_b), kde_b_ms = event_ms(
        lambda: knn_ops.pairwise_kde_reduce(xtb_dev, xtb_dev, mb, inv_b))
    rows_t = torch.from_numpy(rows.astype(np.int64)).to(dev)
    xq_b = xtb_dev[rows_t]
    want_c, want_p = pairwise_dbscan_ref(xq_b, xtb_dev, mb, eps2_b)
    # uint32 tensors take few torch operators on the card: index the bits as int32
    got_pb = packed_b.view(torch.int32)[rows_t].view(torch.uint32)
    near_b, differ_b = compare_dbscan(counts_b[rows_t], got_pb, want_c, want_p,
                                      near_eps(xq_b, xtb_dev, mb, eps2_b), mb, "path B")
    print(f"[3] K4 on {mb} x {res_b.k} (eps {eps_b:.4f}, the 0.005 quantile of sampled distances): "
          f"{dbscan_b_ms:.3f} ms one launch, packed output {packed_b.numel() * 4 / 1e6:.1f} MB, "
          f"{float(counts_b.double().sum()) / mb / mb:.4%} of pairs neighbors; 512 random rows vs the "
          f"plain version: {near_b} pairs within rounding of eps2, {differ_b} bits differ (all on them)")
    want_s, _ = pairwise_kde_ref(xq_b, xtb_dev, mb, inv_b)
    rel_b = compare_kde(sums_b[rows_t], comps_b[rows_t], want_s, xq_b, xtb_dev, mb, inv_b, "path B")
    print(f"[3] K5 on {mb} x {res_b.k} (bandwidth {h_b:.4f}, the median sampled distance): "
          f"{kde_b_ms:.3f} ms one launch; 512 random rows vs the plain version: max relative "
          f"difference {rel_b:.3e}")
    del packed_b, got_pb, want_p

    # ------------------------------------------------------- 4. main path C
    methods = ("pca", "fft", "paa", "dwt", "jl")
    cfg_c = DropConfig(target_tlb=TARGET_TLB, seed=SEED)
    reset_counts()
    t0 = time.perf_counter()
    reports = {
        ds: WorkloadOptimizer(methods=methods, cfg=cfg_c, device="cuda").optimize(xa, ds, execute="all")
        for ds in ("knn", "dbscan", "kde")
    }
    opt_s = time.perf_counter() - t0
    launches_c = read_counts()
    shapes_c = {k_: list(v_) for k_, v_ in calls.items()}
    for ds, rep in reports.items():
        print("[4] WorkloadOptimizer on ecg_like(8000, 1024), execute='all':")
        for line in rep.summary().splitlines():
            print(f"[4]   {line}")
    print(f"[4] three optimize calls: {opt_s:.2f} s wall; launches on path C: {launches_c}")

    pairs_c = sample_pairs(xa.shape[0], 2000, np.random.default_rng(54321))
    diff_c = xa[pairs_c[:, 0]].astype(np.float64) - xa[pairs_c[:, 1]].astype(np.float64)
    norm_c = np.linalg.norm(diff_c, axis=1)
    cpu_fits = {m_: reduce(xa, m_, cfg_c, device="cpu") for m_ in methods if m_ != "pca"}
    for ds, rep in reports.items():
        for m_, o in rep.outcomes.items():
            res = o.result
            fresh = float(np.mean(np.linalg.norm(diff_c @ res.v.astype(np.float64), axis=1) / norm_c))
            line = (f"[4]   {ds:6s} {m_:4s} k {res.k:4d} satisfied {res.satisfied} "
                    f"TLB {res.tlb_estimate:.4f}, on 2,000 fresh pairs {fresh:.4f}")
            if m_ in cpu_fits:
                cpu = cpu_fits[m_]
                line += f"; CPU run k {cpu.k} TLB {cpu.tlb_estimate:.4f}"
                check((res.k, res.tlb_estimate, res.satisfied) == (cpu.k, cpu.tlb_estimate, cpu.satisfied),
                      f"path C {ds} {m_}: the card's fit differs from the CPU run of the same host code")
            print(line)
            check(not res.satisfied or fresh >= TARGET_TLB - 0.01,
                  f"path C {ds} {m_}: fresh-pair TLB {fresh:.4f} < {TARGET_TLB - 0.01}")

    # DBSCAN and KDE on the PCA-reduced data, at a working eps and bandwidth
    xt_c = reports["dbscan"].outcomes["pca"].result.transform(xa)
    eps_c, h_c = eps_for(xt_c)
    t0 = time.perf_counter()
    lab_card = dbscan(xt_c, eps_c, 5, device="cuda")
    dbscan_c_s = time.perf_counter() - t0
    lab_cpu = dbscan(xt_c, eps_c, 5, device="cpu")
    c_card, p_card = pairwise_dbscan(xt_c, eps_c, device="cuda")
    c_cpu, p_cpu = pairwise_dbscan(xt_c, eps_c, device="cpu")
    xt_c_dev = torch.from_numpy(np.ascontiguousarray(xt_c)).to(dev)
    mc = xt_c.shape[0]
    eps2_c = np.float32(eps_c * eps_c)
    def to_dev(a):
        if a.dtype == np.uint32:
            return torch.from_numpy(a.view(np.int32)).to(dev).view(torch.uint32)
        return torch.from_numpy(a).to(dev)

    near_c, differ_c = compare_dbscan(to_dev(c_card), to_dev(p_card), to_dev(c_cpu), to_dev(p_cpu),
                                      near_eps(xt_c_dev, xt_c_dev, mc, eps2_c), mc, "path C")
    n_clusters = len(set(lab_card.tolist()) - {-1})
    print(f"[4] DBSCAN on the PCA-reduced {mc} x {xt_c.shape[1]} (eps {eps_c:.4f}, the 0.005 quantile of "
          f"sampled distances, min_samples 5) on the card: {dbscan_c_s * 1e3:.1f} ms host clock; "
          f"{n_clusters} clusters, {int((lab_card == -1).sum())} noise points; {near_c} pairs within "
          f"rounding of eps2, {differ_c} neighbor bits differ card vs CPU (all on such pairs); labels "
          f"card vs CPU: {int((lab_card != lab_cpu).sum())} differ")
    if differ_c == 0:
        check(bool((lab_card == lab_cpu).all()), "path C: DBSCAN labels differ with identical neighbor bits")
    else:
        print(f"[4]   {differ_c} neighbor bits at the eps boundary fell on different sides on the card and "
              "the CPU (near-tie): labels are not compared")
    t0 = time.perf_counter()
    dens_card = gaussian_kde(xt_c, bandwidth=h_c, device="cuda")
    kde_c_s = time.perf_counter() - t0
    dens_cpu = gaussian_kde(xt_c, bandwidth=h_c, device="cpu")
    inv_c = np.float32(1.0 / (2.0 * h_c * h_c))
    rel_c = compare_kde(to_dev(dens_card), torch.zeros(mc, device=dev), to_dev(dens_cpu),
                        xt_c_dev, xt_c_dev, mc, inv_c, "path C")
    print(f"[4] KDE on the PCA-reduced data (bandwidth {h_c:.4f}, the median sampled distance) on the "
          f"card: {kde_c_s * 1e3:.2f} ms host clock; card vs CPU max relative difference {rel_c:.3e}")

    for kname in ("matmul", "pairwise_tlb", "pairwise_knn"):
        check(launches_a[kname] > 0, f"{kname} was not launched on main path A")
        check(launches_b[kname] > 0, f"{kname} was not launched on main path B")
    for kname in launches_c:
        check(launches_c[kname] > 0, f"{kname} was not launched on main path C")

    # ------------------------------------- 5. kernels at the main paths' shapes
    for undo in restore:
        undo()

    def rebuild(desc):
        shape, stride, dtype = desc
        if len(shape) == 2 and stride[0] == 1 and shape[1] > 1:  # a transposed view
            return normal(shape[1], shape[0]).to(dtype).T
        return normal(*shape).to(dtype)

    def heaviest(log, work):
        return max(log, key=work)

    out = []
    mm_call = heaviest(shapes_a["matmul"], lambda c_: c_[0][0][0] * c_[0][0][1] * c_[1][0][1])
    a, b = rebuild(mm_call[0]), rebuild(mm_call[1])
    m, k = a.shape
    n = b.shape[1]
    kern = sync_ms(lambda: mm_ops.matmul(a, b))
    plain = sync_ms(lambda: matmul_ref(a, b))
    lib = sync_ms(lambda: torch.matmul(a, b))
    bms, bby = bound_ms(4.0 * (m * k + k * n + m * n), 2.0 * m * n * k)
    out.append(dict(name="matmul", route="cuda", source="src/repro_torch/kernels/csrc/matmul.cu",
                    replaces="src/repro/kernels/matmul/matmul.py:41",
                    shape=f"({m},{k})@({k},{n}) a.stride={tuple(a.stride())}",
                    calls_on_path_a=len(shapes_a["matmul"]), max_abs_err=errs["matmul"],
                    max_abs_err_bf16=errs["matmul_bf16"], ms=kern, plain_ms=plain, bound_ms=bms,
                    bound_by=bby, library_ms=lib))

    tlb_call = heaviest(shapes_a["pairwise_tlb"], lambda c_: c_[0][0][0] * c_[2][0][1])
    p, d = tlb_call[0][0]
    kdim = tlb_call[2][0][1]
    xi, xj = normal(p, d), normal(p, d)
    v = torch.linalg.qr(normal(d, kdim))[0].contiguous()
    kern = sync_ms(lambda: tlb_ops.pairwise_tlb(xi, xj, v))
    plain = sync_ms(lambda: pairwise_tlb_ref(xi, xj, v))
    bms, bby = bound_ms(4.0 * (2 * p * d + d * kdim + p * kdim),
                        2.0 * p * d * kdim + 3.0 * p * d + 4.0 * p * kdim)
    out.append(dict(name="pairwise_tlb", route="cuda", source="src/repro_torch/kernels/csrc/pairwise_tlb.cu",
                    replaces="src/repro/kernels/pairwise_tlb/pairwise_tlb.py:50",
                    shape=f"P={p} d={d} K={kdim}", calls_on_path_a=len(shapes_a["pairwise_tlb"]),
                    max_abs_err=errs["pairwise_tlb"], ms=kern, plain_ms=plain, bound_ms=bms,
                    bound_by=bby, library_ms=None))

    knn_call = heaviest(shapes_a["pairwise_knn"], lambda c_: c_[0][0][0] * c_[1][0][0])
    mq, d = knn_call[0][0]
    mk = knn_call[1][0][0]
    xk = normal(mk, d)
    kern = sync_ms(lambda: knn_ops.pairwise_knn_reduce(xk[:mq], xk, mk))
    plain = sync_ms(lambda: pairwise_knn_ref(xk[:mq], xk, mk), iters=5)
    bms, bby = bound_ms(4.0 * (mq * d + mk * d) + 8.0 * mq,
                        2.0 * mq * mk * d + 4.0 * mq * mk + 2.0 * (mq + mk) * d)
    out.append(dict(name="pairwise_knn", route="cuda", source="src/repro_torch/kernels/csrc/pairwise_knn.cu",
                    replaces="src/repro/kernels/pairwise_reduce/pairwise_reduce.py:213",
                    shape=f"mq={mq} mk={mk} d={d}", calls_on_path_a=len(shapes_a["pairwise_knn"]),
                    max_abs_err=errs["pairwise_knn"], ms=kern, plain_ms=plain, bound_ms=bms,
                    bound_by=bby, library_ms=None))

    def dbscan_bound(mq_, mk_, d_, m_):
        words = -(-mk_ // 32)
        return bound_ms(4.0 * (mq_ * d_ + mk_ * d_) + 4.0 * mq_ + 4.0 * mq_ * words,
                        2.0 * mq_ * m_ * d_ + 3.0 * mq_ * m_ + 2.0 * (mq_ + mk_) * d_)

    def kde_bound(mq_, mk_, d_, m_):
        # per pair: the dot product, the d2 expression (3), max and scale
        # (2) and the Neumaier add (4), beside one exponential
        return bound_ms(4.0 * (mq_ * d_ + mk_ * d_) + 8.0 * mq_,
                        2.0 * mq_ * m_ * d_ + 9.0 * mq_ * m_ + 2.0 * (mq_ + mk_) * d_, float(mq_ * m_))

    def chunked(fn, rows_per=7000):
        """The plain version over row blocks: its full distance matrix at
        70,000 rows would take 19.6 GB."""
        return lambda: [fn(xtb_dev[a_:a_ + rows_per]) for a_ in range(0, mb, rows_per)]

    dc = xt_c_dev.shape[1]
    db = xtb_dev.shape[1]
    pr_kernels = (
        ("pairwise_dbscan", "src/repro_torch/kernels/csrc/pairwise_dbscan.cu", 253, dbscan_bound,
         lambda xq_, x_, m_: knn_ops.pairwise_dbscan_reduce(xq_, x_, m_, eps2_c),
         lambda xq_, x_, m_: pairwise_dbscan_ref(xq_, x_, m_, eps2_c),
         lambda xq_: knn_ops.pairwise_dbscan_reduce(xq_, xtb_dev, mb, eps2_b),
         lambda xq_: pairwise_dbscan_ref(xq_, xtb_dev, mb, eps2_b)),
        ("pairwise_kde", "src/repro_torch/kernels/csrc/pairwise_kde.cu", 297, kde_bound,
         lambda xq_, x_, m_: knn_ops.pairwise_kde_reduce(xq_, x_, m_, inv_c),
         lambda xq_, x_, m_: pairwise_kde_ref(xq_, x_, m_, inv_c),
         lambda xq_: knn_ops.pairwise_kde_reduce(xq_, xtb_dev, mb, inv_b),
         lambda xq_: pairwise_kde_ref(xq_, xtb_dev, mb, inv_b)),
    )
    for kname, source, line, bound, kern_c, plain_c, kern_b, plain_b in pr_kernels:
        kern = sync_ms(lambda: kern_c(xt_c_dev, xt_c_dev, mc))
        plain = sync_ms(lambda: plain_c(xt_c_dev, xt_c_dev, mc), iters=5)
        bms, bby = bound(mc, mc, dc, mc)
        kern_big = sync_ms(lambda: kern_b(xtb_dev), iters=5, warmup=1)
        plain_big = sync_ms(chunked(plain_b), iters=2, warmup=1)
        bms_big, bby_big = bound(mb, mb, db, mb)
        out.append(dict(name=kname, route="cuda", source=source,
                        replaces=f"src/repro/kernels/pairwise_reduce/pairwise_reduce.py:{line}",
                        shape=f"mq={mc} mk={mc} d={dc} (path C, DROP's k)",
                        calls_on_path_c=len(shapes_c[kname]), max_abs_err=errs[kname], ms=kern,
                        plain_ms=plain, bound_ms=bms, bound_by=bby, library_ms=None,
                        path_b_shape=f"mq={mb} mk={mb} d={db}", path_b_ms=kern_big,
                        path_b_plain_ms=plain_big, path_b_bound_ms=bms_big, path_b_bound_by=bby_big))
    for entry in out:
        own = launches_c if entry["name"] in ("pairwise_dbscan", "pairwise_kde") else launches_a
        entry["launches"] = own[entry["name"]]
        entry["launches_path_a"] = launches_a[entry["name"]]
        entry["launches_path_b"] = launches_b[entry["name"]]
        entry["launches_path_c"] = launches_c[entry["name"]]
        print(f"[5] {entry['name']} at {entry['shape']}: kernel {entry['ms']:.4f} ms, "
              f"plain {entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}), "
              f"library {entry['library_ms'] if entry['library_ms'] is None else round(entry['library_ms'], 4)} ms")
        if "path_b_ms" in entry:
            print(f"[5] {entry['name']} at {entry['path_b_shape']} (path B): kernel {entry['path_b_ms']:.4f} ms, "
                  f"plain {entry['path_b_plain_ms']:.4f} ms (10 row blocks of 7,000), bound "
                  f"{entry['path_b_bound_ms']:.4f} ms ({entry['path_b_bound_by']})")

    print(f"[5] total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
