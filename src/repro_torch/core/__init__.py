"""DROP core: the paper's primary contribution (progressive-sampling PCA
optimizer with sampled TLB validation and cost-based termination), and the
Reducer protocol that puts it beside the baselines."""

from repro_torch.core.bucketing import DEFAULT_BUCKETS, ShapeBucketCache  # noqa: F401
from repro_torch.core.drop import PcaDropReducer, drop  # noqa: F401
from repro_torch.core.reducer import (  # noqa: F401
    REDUCER_METHODS,
    DwtReducer,
    FftReducer,
    JlReducer,
    PaaReducer,
    Reducer,
    SingleShotReducer,
    make_reducer,
    method_operator,
    reduce,
)
from repro_torch.core.types import (  # noqa: F401
    DEFAULT_SCHEDULE,
    DropConfig,
    IterationRecord,
    ReduceResult,
)
