from spfresh_tpu.ops.distances import (
    CHEBYSHEV,
    EUCLIDEAN,
    MANHATTAN,
    METRICS,
    canonical_metric,
    distance,
    pairwise_distance,
    rowwise_distance,
    slab_distances,
)
from spfresh_tpu.ops.topk import smallest_k, smallest_k_unique

__all__ = [
    "CHEBYSHEV",
    "EUCLIDEAN",
    "MANHATTAN",
    "METRICS",
    "canonical_metric",
    "distance",
    "pairwise_distance",
    "rowwise_distance",
    "slab_distances",
    "smallest_k",
    "smallest_k_unique",
]
