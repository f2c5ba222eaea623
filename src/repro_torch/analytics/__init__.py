"""Downstream analytics priced by DROP's cost model: k-NN retrieval, DBSCAN
clustering and Gaussian kernel density estimation, each one pairwise scan
(``pairwise``); ``*_legacy`` variants keep the blocked host loops as parity
oracles."""

from repro_torch.analytics.dbscan import dbscan, dbscan_legacy  # noqa: F401
from repro_torch.analytics.kde import gaussian_kde, gaussian_kde_legacy  # noqa: F401
from repro_torch.analytics.knn import (  # noqa: F401
    knn_retrieval_accuracy,
    nearest_neighbors,
    nearest_neighbors_legacy,
)
from repro_torch.analytics.pairwise import (  # noqa: F401
    NeighborDecoder,
    kde_from_compensated,
    pairwise_dbscan,
    pairwise_kde,
    pairwise_knn,
    unpack_neighbors,
)
