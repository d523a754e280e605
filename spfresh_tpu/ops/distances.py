"""Batched distance kernels — the accelerator replacement for the reference's
per-pair trait-object kernels (/root/reference/src/distances/distance.rs:7-43).

The reference computes one scalar distance per call behind ``dyn
DistanceMetric``; every hot loop there is a Python-style loop over pairs.  On
the device the unit of work is a *matrix* of distances:

* ``squared_euclidean`` rides the matrix units via the expansion
  ``|x - y|^2 = |x|^2 + |y|^2 - 2 x.y`` — a single large matmul plus rank-1
  corrections, O(n*m*d) FLOPs at matmul speed.
* ``manhattan`` / ``chebyshev`` are elementwise |x-y| reductions, tiled so
  the (tile_n, m, d) broadcast intermediate stays within a memory budget.

All functions accept f32 or bf16 inputs and accumulate in f32
(``preferred_element_type``), matching the f32 reference semantics.

Metric name strings ("Euclidean" | "Manhattan" | "Chebyshev") match the
reference's config whitelist (/root/reference/src/spann/config.rs:59-87).
Note: like the reference, "Euclidean" means *squared* Euclidean everywhere
(ndarray-stats ``sq_l2_dist`` at distance.rs:19) — ordering-equivalent for
nearest-neighbor work and cheaper (no sqrt).
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from spfresh_tpu.core.dtypes import ACCUM_DTYPE

EUCLIDEAN = "Euclidean"
MANHATTAN = "Manhattan"
CHEBYSHEV = "Chebyshev"
METRICS: Sequence[str] = (EUCLIDEAN, MANHATTAN, CHEBYSHEV)


def canonical_metric(name: str) -> str:
    """Validate/normalise a metric name (case-insensitive)."""
    lowered = str(name).strip().lower()
    for m in METRICS:
        if lowered == m.lower():
            return m
    raise ValueError(f"unknown distance metric {name!r}; expected one of {list(METRICS)}")


# ---------------------------------------------------------------------------
# Pairwise (n, d) x (m, d) -> (n, m)
# ---------------------------------------------------------------------------


def _sq_l2_pairwise(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    # Matmul path: |x|^2 + |y|^2 - 2 x.y with f32 accumulation.  HIGHEST
    # keeps f32 operands out of TF32 on the GPU: the closure rule, the
    # medoid argmin and the ground-truth prefilter are sensitive at TF32's
    # ~10 mantissa bits.  bf16 x bf16 products are exact either way.
    xf = x.astype(ACCUM_DTYPE)
    yf = y.astype(ACCUM_DTYPE)
    x2 = jnp.sum(xf * xf, axis=-1, keepdims=True)  # (n, 1)
    y2 = jnp.sum(yf * yf, axis=-1)  # (m,)
    xy = jax.lax.dot_general(
        x,
        y,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=ACCUM_DTYPE,
    )
    d = x2 + y2[None, :] - 2.0 * xy
    # The expansion can go slightly negative from rounding; distances are >= 0.
    return jnp.maximum(d, 0.0)


def _elementwise_pairwise(x: jnp.ndarray, y: jnp.ndarray, metric: str, tile_n: int) -> jnp.ndarray:
    """Elementwise path: tiled (x[:,None,:] - y[None,:,:]) reduction.  XLA
    fuses each tile's subtract, abs and sum/max into one reduction.  Also
    serves as the *exact* squared-L2 path — the matmul expansion loses ~1e-3 relative
    precision to cancellation, which matters for ground-truth computation."""
    xf = x.astype(ACCUM_DTYPE)
    yf = y.astype(ACCUM_DTYPE)
    n = xf.shape[0]
    # Bound the (tile, m, d) broadcast intermediate to ~256 MB.
    budget_rows = max(8, (1 << 26) // max(1, y.shape[0] * y.shape[1]))
    tile_n = max(1, min(tile_n, budget_rows, n))
    pad = (-n) % tile_n
    if pad:
        xf = jnp.pad(xf, ((0, pad), (0, 0)))
    xt = xf.reshape(-1, tile_n, xf.shape[-1])

    def one_tile(xb):
        diff = xb[:, None, :] - yf[None, :, :]
        if metric == EUCLIDEAN:
            return jnp.sum(diff * diff, axis=-1)
        if metric == MANHATTAN:
            return jnp.sum(jnp.abs(diff), axis=-1)
        return jnp.max(jnp.abs(diff), axis=-1)

    out = jax.lax.map(one_tile, xt).reshape(-1, yf.shape[0])
    return out[:n]


@functools.partial(jax.jit, static_argnames=("metric", "tile_n", "exact"))
def pairwise_distance(
    x: jnp.ndarray,
    y: jnp.ndarray,
    metric: str = EUCLIDEAN,
    tile_n: int = 1024,
    exact: bool = False,
) -> jnp.ndarray:
    """All-pairs distances between rows of ``x`` (n, d) and ``y`` (m, d).

    Returns an (n, m) f32 matrix.  ``metric`` is one of
    ``"Euclidean"`` (squared L2), ``"Manhattan"`` (L1), ``"Chebyshev"`` (Linf).
    For Euclidean, ``exact=False`` (default) uses the fast matmul expansion
    (adequate for probe selection); ``exact=True`` uses the elementwise
    difference form (bit-matched with ``rowwise_distance``, for rerank-grade
    precision and ground truth).
    """
    metric = canonical_metric(metric)
    if x.ndim != 2 or y.ndim != 2:
        raise ValueError(f"expected 2-d inputs, got {x.shape} and {y.shape}")
    if x.shape[-1] != y.shape[-1]:
        raise ValueError(f"dimension mismatch: {x.shape[-1]} vs {y.shape[-1]}")
    if metric == EUCLIDEAN and not exact:
        return _sq_l2_pairwise(x, y)
    return _elementwise_pairwise(x, y, metric, tile_n)


@functools.partial(jax.jit, static_argnames=("metric",))
def distance(u: jnp.ndarray, v: jnp.ndarray, metric: str = EUCLIDEAN) -> jnp.ndarray:
    """Single-pair distance (parity with ``DistanceMetric::compute``,
    /root/reference/src/distances/distance.rs:7-10).  Scalar output."""
    metric = canonical_metric(metric)
    uf = jnp.asarray(u, ACCUM_DTYPE).reshape(-1)
    vf = jnp.asarray(v, ACCUM_DTYPE).reshape(-1)
    diff = uf - vf
    if metric == EUCLIDEAN:
        return jnp.sum(diff * diff)
    if metric == MANHATTAN:
        return jnp.sum(jnp.abs(diff))
    return jnp.max(jnp.abs(diff))


def distance_f64(u, v, metric: str = EUCLIDEAN) -> np.float64:
    """HOST-path float64 distance — the reference's ``SpannFloat`` admits f32
    AND f64 (the reference's src/core/float.rs:24-25); the device path is f32,
    so the f64 capability lives on the host (numpy), exact to f64 semantics.
    Use for verification/ground-truth work; the device hot path is
    f32-accumulated by policy (core/dtypes.py)."""
    metric = canonical_metric(metric)
    uf = np.asarray(u, np.float64).reshape(-1)
    vf = np.asarray(v, np.float64).reshape(-1)
    if uf.shape != vf.shape:
        raise ValueError(f"dimension mismatch: {uf.shape} vs {vf.shape}")
    diff = uf - vf
    if metric == EUCLIDEAN:
        return np.float64(np.sum(diff * diff))
    if metric == MANHATTAN:
        return np.float64(np.sum(np.abs(diff)))
    return np.float64(np.max(np.abs(diff)))


@functools.partial(jax.jit, static_argnames=("metric",))
def rowwise_distance(x: jnp.ndarray, y: jnp.ndarray, metric: str = EUCLIDEAN) -> jnp.ndarray:
    """Row-aligned distances: x (..., d) vs y (..., d) -> (...,)."""
    metric = canonical_metric(metric)
    diff = x.astype(ACCUM_DTYPE) - y.astype(ACCUM_DTYPE)
    if metric == EUCLIDEAN:
        return jnp.sum(diff * diff, axis=-1)
    if metric == MANHATTAN:
        return jnp.sum(jnp.abs(diff), axis=-1)
    return jnp.max(jnp.abs(diff), axis=-1)


def slab_distances(queries, rows, vectors3d, metric: str = EUCLIDEAN,
                   scales=None, centered_queries=None) -> jnp.ndarray:
    """Stage 2 of the slab search engine: (Q, nprobe, pad) f32 distances
    between each query and every row of each probed posting slab, as one
    XLA gather of whole ``(pad, d)`` slabs plus a reduction (XLA fuses the
    two).

    Float slabs compare against ``queries`` (Q, d).  int8 slabs hold
    IVF-SQ8 residual codes and take ``scales`` (Q, nprobe) and the probe's
    CENTERED queries ``centered_queries`` (Q, nprobe, d) = q - c_j, so
    |s * r - (q - c_j)| == |x - q|.  ``rows`` may point at any valid slab
    for probes the caller masks afterwards."""
    metric = canonical_metric(metric)
    v = vectors3d[rows].astype(ACCUM_DTYPE)  # (Q, nprobe, pad, d)
    if scales is not None:
        v = v * scales.astype(ACCUM_DTYPE)[..., None, None]
        qv = centered_queries.astype(ACCUM_DTYPE)[:, :, None, :]
    else:
        qv = queries.astype(ACCUM_DTYPE)[:, None, None, :]
    return rowwise_distance(v, qv, metric)
