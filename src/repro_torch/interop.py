"""Fitted maps carried between the JAX package and the port.

DROP has no model weights: its state is the fitted linear map, a
``ReduceResult`` of numpy arrays. These two functions move it across
without importing the JAX package, so a basis fitted by either package
transforms identically in the other.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Any

import numpy as np

from repro_torch.core.types import IterationRecord, ReduceResult

_RECORD_FIELDS = tuple(f.name for f in fields(IterationRecord))


def result_from_reference(res: Any) -> ReduceResult:
    """The port's ``ReduceResult`` from any object with the JAX package's
    ``ReduceResult`` fields (``v``, ``mean``, ``k``, ``tlb_estimate``,
    ``satisfied``, ``runtime_s``, and optionally ``iterations``, ``method``)."""
    return ReduceResult(
        v=np.array(res.v),
        mean=np.array(res.mean),
        k=int(res.k),
        tlb_estimate=float(res.tlb_estimate),
        satisfied=bool(res.satisfied),
        runtime_s=float(res.runtime_s),
        iterations=[
            IterationRecord(**{f: getattr(rec, f) for f in _RECORD_FIELDS})
            for rec in getattr(res, "iterations", [])
        ],
        method=str(getattr(res, "method", "pca")),
    )


def result_to_arrays(res: ReduceResult) -> dict[str, Any]:
    """The fitted map as plain keyword arguments: the JAX package's
    ``ReduceResult(**result_to_arrays(res))`` rebuilds it there."""
    return {
        "v": np.array(res.v),
        "mean": np.array(res.mean),
        "k": int(res.k),
        "tlb_estimate": float(res.tlb_estimate),
        "satisfied": bool(res.satisfied),
        "runtime_s": float(res.runtime_s),
        "method": res.method,
    }
