"""Small clustering helpers (parity: /root/reference/src/clustering/utils.rs)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from spfresh_tpu.core.dtypes import ACCUM_DTYPE


@jax.jit
def compute_mean(data: jnp.ndarray, indices: jnp.ndarray) -> jnp.ndarray:
    """Mean of selected rows (utils.rs:5-15): data (n, d), indices (m,) -> (d,)."""
    return jnp.mean(data[indices].astype(ACCUM_DTYPE), axis=0)


@jax.jit
def masked_means(data: jnp.ndarray, member_mask: jnp.ndarray) -> jnp.ndarray:
    """Per-cluster means from a bool membership mask.

    data (n, d), member_mask (n, k) -> (k, d).  The segment-sum is a single
    mask^T @ data matmul (HIGHEST: no TF32 on f32 data).  Empty clusters get a zero mean (callers
    must guard with counts).
    """
    m = member_mask.astype(ACCUM_DTYPE)
    sums = jax.lax.dot_general(
        m, data,
        dimension_numbers=(((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=ACCUM_DTYPE,
    )  # (k, d)
    counts = jnp.sum(m, axis=0)[:, None]
    return sums / jnp.maximum(counts, 1.0)


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (>=1). Used to bucket padded shapes so the
    level-synchronous subdivision compiles O(log n) kernel variants, not one
    per cluster size."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def budget_sort(e_cls, e_d):
    """Stable (cluster asc, distance asc, input-order) permutation for the
    replica budget pass — the order `np.lexsort((e_d, e_cls))` produces,
    ~2.3x faster at the 1M bench shape (2.5M extras: 1.84 s lexsort vs
    0.82 s here, 1-core host).  Distances are non-negative, so the f32 bit
    pattern is order-preserving as uint32 and one u64 radix key
    (cls << 32 | d_bits) replaces lexsort's two stable merge passes.
    Falls back to lexsort if a negative distance ever appears (it cannot
    today: every metric and the SOAR score are >= 0)."""
    import numpy as np

    e_d = np.ascontiguousarray(e_d, np.float32)
    if len(e_d) and float(e_d.min()) < 0.0:  # pragma: no cover - defensive
        return np.lexsort((e_d, e_cls))
    # +0.0 normalizes any -0.0 (bit 0x80000000 would sort as huge).
    key = (np.asarray(e_cls, np.uint64) << np.uint64(32)) | (
        e_d + np.float32(0.0)
    ).view(np.uint32).astype(np.uint64)
    return np.argsort(key, kind="stable")
