"""Online progress estimation + convex stopping rule (paper §3.5).

Linear (two-point) extrapolation of the next iteration's basis size and
runtime over sample size, and the greedy termination test of Eq. 2:

    terminate iff  C_m(k_i) - C_m(k_hat_{i+1}) < r_hat_{i+1}

— i.e. stop when the projected next-iteration cost exceeds the projected
downstream saving. Theorem 3.1 (objective convex when C_m convex nondecreasing
and k_i a convex sequence) makes this greedy local test globally optimal.
"""

from __future__ import annotations

from repro_torch.core.types import CostFn, IterationRecord


def extrapolate(prev: float, cur: float, m_prev: int, m_cur: int, m_next: int) -> float:
    """Paper §3.5.1 linear interpolation: v_{i+1} = v_i + dv/dm * (m_{i+1}-m_i)."""
    if m_cur == m_prev:
        return cur
    slope = (cur - prev) / float(m_cur - m_prev)
    return cur + slope * float(m_next - m_cur)


def estimate_next(
    records: list[IterationRecord], m_next: int
) -> tuple[float, float]:
    """Estimate (k_hat, r_hat) for the next sample size from the last two
    iterations. k_hat is floored at 1; r_hat at 0."""
    a, b = records[-2], records[-1]
    k_hat = extrapolate(a.k, b.k, a.sample_size, b.sample_size, m_next)
    r_hat = extrapolate(
        a.runtime_s, b.runtime_s, a.sample_size, b.sample_size, m_next
    )
    return max(k_hat, 1.0), max(r_hat, 0.0)


def should_terminate(
    records: list[IterationRecord],
    m_next: int,
    cost: CostFn,
    min_iterations: int = 2,
) -> bool:
    """Eq. 2 greedy stopping criterion."""
    if len(records) < max(min_iterations, 2):
        return False
    if not records[-1].satisfied:
        # no TLB-preserving basis yet: the constraint is not met, keep going
        return False
    k_hat, r_hat = estimate_next(records, m_next)
    saving = cost(records[-1].k) - cost(int(round(k_hat)))
    return saving < r_hat
