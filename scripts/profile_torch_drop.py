"""Where DROP's runtime R goes in the PyTorch port, on one CUDA GPU.

    python3 scripts/profile_torch_drop.py

Runs ``drop`` on ``ecg_like(8000, 1024, seed=0)``, the data of
``chip_smoke.py``'s path A, at target 0.98 once to warm up (kernel build,
solver handles), then once more under ``torch.profiler`` with CPU and CUDA
activities, and prints R, the wall
time, the device's busy time (the union of all kernel and copy intervals)
and busy share of the wall time, and the device time by kernel name,
largest first. It exits non-zero without a GPU or when the profiler
records no device activity. Needs torch, numpy and scipy; not JAX.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from pathlib import Path

ROWS, DIM = 8000, 1024


def busy_intervals(events, device_type):
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in events
        if e.device_type == device_type and e.time_range.end > e.time_range.start
    )
    merged = []
    for start, end in spans:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_drop: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.core import DropConfig, drop
    from repro_torch.data import ecg_like

    x, _ = ecg_like(ROWS, DIM, seed=0)
    cfg = DropConfig(target_tlb=0.98, seed=0)
    drop(x, cfg, device="cuda")  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = drop(x, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    device = torch.autograd.DeviceType.CUDA
    merged = busy_intervals(events, device)
    if not merged:
        print("profile_torch_drop: the profiler recorded no device activity", file=sys.stderr)
        return 1
    busy_us = sum(end - start for start, end in merged)
    by_name = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.device_type == device:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.end - e.time_range.start
    print(torch.cuda.get_device_name(0))
    print(f"ecg_like({ROWS}, {DIM}): {len(res.iterations)} iterations, k {res.k}, "
          f"R {res.runtime_s * 1e3:.2f} ms, wall {wall * 1e3:.2f} ms (profiler on)")
    print(f"device busy {busy_us / 1e3:.3f} ms = {busy_us / 1e3 / (wall * 1e3):.1%} of the wall time "
          f"({len(merged)} busy intervals)")
    print("device time by kernel, largest first:")
    for name, (count, total) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"  {total / 1e3:9.3f} ms  {count:5d} x  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
