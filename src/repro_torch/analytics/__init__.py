"""Downstream analytics priced by DROP's cost model (this slice: 1-NN)."""

from repro_torch.analytics.knn import (  # noqa: F401
    knn_retrieval_accuracy,
    nearest_neighbors,
    nearest_neighbors_legacy,
)
from repro_torch.analytics.pairwise import pairwise_knn  # noqa: F401
