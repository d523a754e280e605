"""Dtype policy for the device build.

The reference bounds usable scalars with a ``SpannFloat`` trait admitting f32/f64
(the reference's src/core/float.rs:9-25).  On the device the analogous policy is:

* **storage dtype** — how vectors live in device memory / on disk.  ``float32``
  by default; ``bfloat16`` halves the device footprint and bandwidth for distance scans (the usual
  bottleneck) at a small recall cost.
* **accumulation dtype** — always ``float32``.  Every matmul passes
  ``preferred_element_type=float32`` so bf16-stored vectors still accumulate
  exactly like the f32 reference within rounding.

float64 is deliberately unsupported on the hot path: GPUs run f64 at a small
fraction of the f32 rate.  Host-side (numpy) code may hold f64 and is cast
on transfer.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

# Canonical accumulation dtype for all distance/centroid math.
ACCUM_DTYPE = jnp.float32

_STORAGE_DTYPES = {
    "float32": jnp.float32,
    "bfloat16": jnp.bfloat16,
    # Symmetric scalar quantization with PER-POSTING scales (the IVF-SQ8
    # shape): each posting slab stores round(x / s_c) in int8 where
    # s_c = max|x over the posting| / 127, and the rerank dequantizes with
    # its slab's scale — so the quantization error tracks the CLUSTER
    # radius, not the corpus dynamic range.  Queries, centroids, and
    # reported distances all stay in real units.  Halves slab HBM + DMA
    # again vs bfloat16 — the rerank is bandwidth-bound — at a small recall
    # cost; the disk format stays exact f32.
    "int8": jnp.int8,
}


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Storage/accumulation dtype pair used across the framework."""

    storage: str = "float32"

    def __post_init__(self):
        if self.storage not in _STORAGE_DTYPES:
            raise ValueError(
                f"unsupported storage dtype {self.storage!r}; "
                f"expected one of {sorted(_STORAGE_DTYPES)}"
            )

    @property
    def storage_dtype(self):
        return _STORAGE_DTYPES[self.storage]

    @property
    def accum_dtype(self):
        return ACCUM_DTYPE

    @property
    def storage_itemsize(self) -> int:
        return jnp.dtype(self.storage_dtype).itemsize

    def to_storage(self, x):
        return jnp.asarray(x, dtype=self.storage_dtype)

    def to_accum(self, x):
        return jnp.asarray(x, dtype=self.accum_dtype)


    @property
    def quantized(self) -> bool:
        return self.storage == "int8"


DEFAULT_POLICY = DtypePolicy()


def quant_scale_for(vecs) -> float:
    """Symmetric int8 scale for one posting: max|x| * (1/127) (host numpy)
    — the SAME f32 expression as :func:`posting_scales_np` and the device
    packs (m / 127 differs from m * (1/127) on ~5% of values at 1 ulp,
    which would break the bit-identity contracts between pack routes).
    Abs-max containment means the quantized members never clip; vectors
    appended later saturate at +-127 (documented)."""
    m = np.float32(np.max(np.abs(np.asarray(vecs, np.float32)), initial=0.0))
    return float(m * np.float32(1.0 / 127.0)) or 1.0


def posting_scales_np(rowmax: np.ndarray) -> np.ndarray:
    """Per-posting scales from per-posting abs-maxima (f32, exact maxima):
    s_c = rowmax_c / 127, with empty/all-zero postings pinned to 1.0 so the
    reciprocal stays finite.  The device pack computes the IDENTICAL f32
    expression — packs from either side are bit-identical."""
    rowmax = np.asarray(rowmax, np.float32)
    return np.where(
        rowmax > 0, rowmax * np.float32(1.0 / 127.0), np.float32(1.0)
    ).astype(np.float32)


def quantize_np(x: np.ndarray, scale) -> np.ndarray:
    """Host-side int8 quantization (round-half-even, saturating).

    Multiplies by the f32 reciprocal — the SAME arithmetic the device cast
    uses (`x * inv_scale`) — so host- and device-packed views are
    bit-identical (x / s differs from x * (1/s) in f32 at .5 boundaries).
    ``scale`` may be a scalar or broadcastable per-row array."""
    inv = np.float32(1.0) / np.asarray(scale, np.float32)
    return np.clip(
        np.rint(np.asarray(x, np.float32) * inv), -127, 127
    ).astype(np.int8)


def as_f32_np(x) -> np.ndarray:
    """Host-side canonicalisation: contiguous float32 numpy array."""
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))
