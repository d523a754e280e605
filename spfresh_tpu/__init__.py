"""spfresh_tpu — a JAX SPANN/SPFresh approximate-nearest-neighbor engine.

Built from scratch in JAX/XLA/Pallas with the capability surface of the
SPFresh reference (see SURVEY.md): hierarchical balanced clustering into
posting lists, a device-resident centroid index scanned with fused
distance/top-nprobe kernels, disk persistence, metric-pluggable search,
SPFresh/LIRE in-place updates, and multi-device scale-out over a
``jax.sharding.Mesh``.
"""

__version__ = "0.1.0"

from spfresh_tpu.clustering import ClusteringParams, HierarchicalClustering
from spfresh_tpu.ops import (
    CHEBYSHEV,
    EUCLIDEAN,
    MANHATTAN,
    METRICS,
    distance,
    pairwise_distance,
)

__all__ = [
    "CHEBYSHEV",
    "EUCLIDEAN",
    "MANHATTAN",
    "METRICS",
    "ClusteringParams",
    "HierarchicalClustering",
    "distance",
    "pairwise_distance",
    "__version__",
]
