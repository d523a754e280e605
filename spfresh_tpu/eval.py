"""Recall / precision evaluation harness (parity:
/root/reference/src/main.rs:73-115 — the reference's end-to-end SIFT-small
precision run), batched on the device.

The reference computes per-query precision = |result intersect gt| / k and
logs it (main.rs:73-77).  Here evaluation is vectorized over the whole query
set and also reports QPS, plus an nprobe sweep helper for the recall/QPS
curves in BASELINE.md.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional, Sequence

import numpy as np

from spfresh_tpu.index.spann import SpannIndex, brute_force_search

log = logging.getLogger(__name__)


def mixture_corpus(n: int, nq: int, dim: int, seed: int, spread: float = 0.7,
                   latent_dim: Optional[int] = None):
    """(data (n, dim), queries (nq, dim)) f32 from a seeded Gaussian mixture.

    Real embedding corpora are clustered; uniform Gaussian noise has no
    nearest-neighbor structure and degenerates every IVF index to a full
    scan.  ``max(64, n // 1000)`` centers, each point a center plus
    ``spread`` x N(0, 1); queries come from the same mixture (as SIFT's
    do).  ``latent_dim`` L draws the mixture on an L-dimensional linear
    manifold embedded in ``dim`` plus 1% ambient noise: real descriptor
    corpora are low-LID (SIFT ~10-13, GIST ~20-30), while a full-rank 960-d
    Gaussian has LID ~275."""
    rng = np.random.default_rng(seed)
    n_centers = max(64, n // 1000)
    if latent_dim is not None:
        L = latent_dim
        proj = rng.standard_normal((L, dim)).astype(np.float32) / np.sqrt(L)
        centers = rng.standard_normal((n_centers, L)).astype(np.float32)

        def draw(m):
            a = rng.integers(0, n_centers, size=m)
            lat = centers[a] + spread * rng.standard_normal((m, L))
            amb = 0.01 * rng.standard_normal((m, dim))
            return (lat.astype(np.float32) @ proj + amb).astype(np.float32)

    else:
        centers = rng.standard_normal((n_centers, dim)).astype(np.float32)

        def draw(m):
            a = rng.integers(0, n_centers, size=m)
            return (
                centers[a] + spread * rng.standard_normal((m, dim))
            ).astype(np.float32)

    data = draw(n)
    return data, draw(nq)


# nprobe values swept, in order, to find the smallest reaching a recall bar.
NPROBE_SWEEP = (2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128)


def sift1m_config(storage_dtype: str = "float32", **clustering):
    """The build configuration of the SIFT1M-shape runs (``chip_smoke.py``,
    ``benchmarks/rerank_bench.py``): Euclidean, KMeans++, cluster size 256,
    seed 42; ``clustering`` overrides clustering parameters."""
    from spfresh_tpu.index.config import Config

    return Config.from_dict(
        {
            "clustering_params": {
                "distance_metric": "Euclidean",
                "initialization_method": "KMeans++",
                "initial_k": 16,
                "desired_cluster_size": 256,
                "rng_seed": 42,
                **clustering,
            },
            "storage_dtype": storage_dtype,
        }
    )


def recall_at_k(result_ids: np.ndarray, groundtruth: np.ndarray, k: Optional[int] = None) -> float:
    """Mean |result ∩ gt| / k over queries (compare_results, main.rs:73-77).

    result_ids (Q, >=k) with -1 padding; groundtruth (Q, >=k)."""
    if k is None:
        k = min(result_ids.shape[1], groundtruth.shape[1])
    hits = 0
    for r, g in zip(result_ids[:, :k], groundtruth[:, :k]):
        hits += len(set(int(x) for x in r if x >= 0) & set(int(x) for x in g))
    return hits / (len(result_ids) * k)


@dataclasses.dataclass
class EvalResult:
    recall: float
    qps: float
    k: int
    nprobe: int
    latency_ms_per_batch: float


def evaluate(
    index: SpannIndex,
    queries: np.ndarray,
    groundtruth: np.ndarray,
    k: int = 10,
    nprobe: Optional[int] = None,
    batch_size: Optional[int] = None,
    warmup: bool = True,
) -> EvalResult:
    """Timed recall evaluation.  ``groundtruth`` may come from an ivecs file
    or ``brute_force_search``."""
    queries = np.asarray(queries, np.float32)
    nprobe_eff = nprobe if nprobe is not None else (index.config.search.nprobe or k)
    if warmup:
        index.search(queries[:1], k, nprobe=nprobe)  # compile outside the clock
    t0 = time.perf_counter()
    ids, _ = index.search(queries, k, nprobe=nprobe, batch_size=batch_size)
    dt = time.perf_counter() - t0
    rec = recall_at_k(ids, np.asarray(groundtruth), k)
    nbatches = max(1, -(-len(queries) // (batch_size or index.config.search.query_batch_size)))
    res = EvalResult(
        recall=rec,
        qps=len(queries) / dt,
        k=k,
        nprobe=int(nprobe_eff),
        latency_ms_per_batch=1e3 * dt / nbatches,
    )
    log.info("eval: recall@%d=%.4f qps=%.0f nprobe=%s", k, rec, res.qps, nprobe_eff)
    return res


def nprobe_sweep(
    index: SpannIndex,
    queries: np.ndarray,
    groundtruth: np.ndarray,
    k: int = 10,
    nprobes: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128),
    batch_size: Optional[int] = None,
) -> List[EvalResult]:
    """Recall/QPS curve over nprobe (BASELINE.md config 3)."""
    out = []
    for np_ in nprobes:
        if np_ > index.num_clusters:
            break
        out.append(evaluate(index, queries, groundtruth, k, np_, batch_size))
    return out


def make_groundtruth(data: np.ndarray, queries: np.ndarray, k: int, metric: str = "Euclidean") -> np.ndarray:
    """Exact ground truth via on-device brute force."""
    _, gt = brute_force_search(data, queries, k, metric)
    return gt
