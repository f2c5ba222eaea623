"""Shape-bucket quantization of the fit width and the fit's sample rows.

The JAX package quantizes data-dependent sizes so its jitted stages see a
bounded set of shapes. PyTorch runs eagerly and needs no compile cache, but
two of those roundings change what is computed, and the port keeps them so
that the same inputs give the same bases in both packages:

* ``bucket_rank`` — the Halko fit runs at width ``max(cap_pad, cap)``, which
  sets ``l = min(k + oversample, m, d)`` and so the shape of Ω.
* ``bucket_rows`` — the fit zero-pads the sample to the row bucket and
  centers it with a row mask; the padded row count enters the same ``l``.

Pair batches are not padded: each TLB table row is computed independently
of the others, so padding would change nothing but the work.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def round_up(n: int, quantum: int) -> int:
    """Smallest multiple of ``quantum`` that is >= n (n <= 0 maps to quantum)."""
    n = max(int(n), 1)
    q = max(int(quantum), 1)
    return ((n + q - 1) // q) * q


@dataclass
class BucketStats:
    """Per-family telemetry: how often a request landed in an existing bucket."""

    hits: int = 0
    misses: int = 0
    sizes: set = field(default_factory=set)

    @property
    def requests(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.requests if self.requests else 0.0


class ShapeBucketCache:
    """Quantizes the fit width (``rank``) and the fit's sample rows
    (``rows``), with the JAX package's quanta and rounding."""

    def __init__(self, rank_quantum: int = 32, row_quantum: int = 64) -> None:
        self.rank_quantum = rank_quantum
        self.row_quantum = row_quantum
        self.stats: dict[str, BucketStats] = {
            "rank": BucketStats(),
            "rows": BucketStats(),
        }

    def _record(self, family: str, size: int) -> int:
        st = self.stats[family]
        if size in st.sizes:
            st.hits += 1
        else:
            st.misses += 1
            st.sizes.add(size)
        return size

    def bucket_rank(self, cap: int, hard_cap: int) -> int:
        """Padded fit width for a search cap of ``cap``: next multiple of
        ``rank_quantum``, never beyond ``hard_cap`` = min(m_i, d)."""
        padded = min(max(int(hard_cap), 1), round_up(cap, self.rank_quantum))
        return self._record("rank", max(padded, max(int(cap), 1)))

    def bucket_rows(self, n: int) -> int:
        """Padded sample-row count for the PCA fit (masked centering keeps the
        zero rows out of the mean; zero rows never change right singular
        vectors, so the padded fit is exact for the real rows)."""
        return self._record("rows", round_up(n, self.row_quantum))


# Shared default: every drop() that does not bring its own cache quantizes
# through this instance, as the JAX package's DEFAULT_BUCKETS does.
DEFAULT_BUCKETS = ShapeBucketCache()
