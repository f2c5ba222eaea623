"""DROP core: the paper's primary contribution (progressive-sampling PCA
optimizer with sampled TLB validation and cost-based termination)."""

from repro_torch.core.bucketing import DEFAULT_BUCKETS, ShapeBucketCache  # noqa: F401
from repro_torch.core.drop import PcaDropReducer, drop  # noqa: F401
from repro_torch.core.types import (  # noqa: F401
    DEFAULT_SCHEDULE,
    DropConfig,
    IterationRecord,
    ReduceResult,
)
