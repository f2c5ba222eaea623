"""End-to-end DR pipeline optimization: race any ``Reducer`` against the
downstream analytics it feeds, objective R + C_m(k) (paper §3.1 / §4.4)."""

from repro_torch.pipeline.optimizer import (  # noqa: F401
    DOWNSTREAMS,
    MethodOutcome,
    OptimizerReport,
    WorkloadOptimizer,
    run_downstream,
)
