"""SPANN index — accelerator core in JAX (parity: the reference's src/spann/spann_index.rs).

Reference design: an in-memory kiddo k-d tree over centroids + per-cluster
posting files paged from disk, searched one query at a time
(spann_index.rs:17-21,148-197).  Device re-design:

* the k-d tree becomes an **HBM-resident centroid matrix** scanned with a
  batched fused distance + top-nprobe selection — at SPANN centroid counts a
  dense matmul scan is exact and maps onto the accelerator far better than
  tree traversal (SURVEY.md section 7);
* posting lists live in a flat **CSR layout** (ids, vectors, offsets) padded
  once to static shapes, so the probe -> gather -> rerank -> merge pipeline is
  a single jitted program over a whole query batch;
* search exposes ``nprobe`` independently of ``k`` (the reference conflates
  them, spann_index.rs:164 — SURVEY.md quirk 2), reranks with the
  **configured** metric (the reference hardwires SquaredEuclidean,
  spann_index.rs:164,172 — quirk 1), and makes the 1.2x dynamic pruning an
  *option* (`prune_factor`) rather than an always-on recall hazard (quirk 3).

Mutable-update support (SPFresh/LIRE) keeps canonical posting state in host
dicts; the device view is a compiled snapshot, re-packed lazily when dirty.
Capacity is padded geometrically so steady-state updates do not recompile.
"""

from __future__ import annotations

import dataclasses
import functools
import gzip
import json
import logging
import os
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spfresh_tpu.core.dtypes import (
    ACCUM_DTYPE,
    DtypePolicy,
    quantize_np,
)
from spfresh_tpu.index.config import Config
from spfresh_tpu.index.posting_store import (
    FileBasedPostingListStore,
    PointData,
    read_packed_postings,
    write_packed_postings,
    write_packed_postings_streaming,
)
from spfresh_tpu.ops.distances import (
    canonical_metric,
    pairwise_distance,
    rowwise_distance,
    slab_distances,
)
from spfresh_tpu.ops.topk import centroid_topk, smallest_k, smallest_k_unique
from spfresh_tpu.utils import metrics

MANIFEST = "manifest.json"
CENTROIDS_FILE = "centroids.npy.gz"
PACKED_FILE = "postings.csr"
_F32_EPS = float(np.finfo(np.float32).eps)
log = logging.getLogger(__name__)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()



def _ids_i32(a: np.ndarray) -> np.ndarray:
    """Device views carry point ids as int32 (x64 is disabled in JAX by default; an
    implicit int64 view would be silently truncated).  Ids must fit — past
    2^31 points, re-map ids before indexing (the host/storage tier keeps
    int64 throughout)."""
    if a.size and (int(a.max()) >= np.iinfo(np.int32).max or int(a.min()) < -1):
        raise ValueError(
            "point ids must fit in int32 for the device view "
            f"(got max {int(a.max())}, min {int(a.min())}); re-map ids"
        )
    return a.astype(np.int32)


def _max_multiplicity(all_ids: np.ndarray) -> int:
    """Largest number of postings any single point id appears in (replicas).
    Drives the exact-dedup oversampling bound in smallest_k_unique."""
    if all_ids.size == 0:
        return 1
    _, counts = np.unique(all_ids, return_counts=True)
    return int(counts.max())


# ---------------------------------------------------------------------------
# Jitted search pipeline
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("k", "nprobe", "pad", "metric", "prune", "max_dup")
)
def _search_kernel(
    queries,
    centroids,
    cent_valid,
    offsets,
    lens,
    ids,
    vectors,
    scales,
    prune_factor,
    *,
    k: int,
    nprobe: int,
    pad: int,
    metric: str,
    prune: bool,
    max_dup: int = 8,
    q_scales=None,  # (Q, 1) f32 when queries are int8 codes
):
    """probe -> gather -> rerank -> merge for one query batch.

    queries (Q, d); centroids (C, d); offsets/lens (C,); ids (P,);
    vectors (P, d).  Returns (ids (Q, k) int64 [-1 = no hit], dists (Q, k)).
    """
    Q = queries.shape[0]
    if q_scales is not None:  # int8 query wire: dequantize on device
        queries = queries.astype(jnp.float32) * q_scales
    qf = queries.astype(centroids.dtype)

    # Stage 1 — centroid scan + top-nprobe (replaces kdtree.nearest_n,
    # spann_index.rs:164); streams the centroid matrix in chunks past ~32k
    # centroids instead of materializing (Q, C).
    cent_d, cent_i = centroid_topk(qf, centroids, cent_valid, nprobe, metric)

    # Stage 2 — gather probed posting lists (replaces the per-list disk read,
    # spann_index.rs:169).
    base = offsets[cent_i].astype(jnp.int32)  # (Q, nprobe)
    ar = jnp.arange(pad, dtype=jnp.int32)
    pos = base[..., None] + ar  # (Q, nprobe, pad)
    valid = (ar < lens[cent_i][..., None]) & jnp.isfinite(cent_d)[..., None]
    pos = jnp.clip(pos, 0, vectors.shape[0] - 1)
    cand_vecs = vectors[pos]  # (Q, nprobe, pad, d)
    if vectors.dtype == jnp.int8:
        # IVF-SQ8 reconstruction: x = centroid + scale * residual code —
        # the gather already moved 1/4 the bytes.
        cand_vecs = (
            cand_vecs.astype(ACCUM_DTYPE) * scales[cent_i][..., None, None]
            + centroids[cent_i].astype(ACCUM_DTYPE)[:, :, None, :]
        )
    # Padding reads past a short cluster land in the next cluster's slice;
    # neutralize their ids so they can never shadow a real candidate.
    cand_ids = jnp.where(valid, ids[pos], -1)

    # Stage 3 — rerank with the configured metric (fixes quirk 1), against
    # the unrounded queries as the slab layout and the lazy tier do: only
    # the stage-1 scan runs in the storage dtype.
    d = rowwise_distance(cand_vecs, queries[:, None, None, :], metric)
    d = jnp.where(valid, d, jnp.inf)
    if prune:
        # Reference-style query-aware dynamic pruning (spann_index.rs:165,176):
        # keep points within prune_factor * (nearest-centroid distance + eps).
        thr = prune_factor.astype(ACCUM_DTYPE) * (cent_d[:, 0] + _F32_EPS)
        d = jnp.where(d <= thr[:, None, None], d, jnp.inf)

    # Stage 4 — global top-k with replica dedup (replaces sort+truncate,
    # spann_index.rs:188-193).
    n_cand = nprobe * pad
    d = d.reshape(Q, n_cand)
    cand_ids = cand_ids.reshape(Q, n_cand)
    if n_cand < k:  # degenerate tiny index: pad so top_k is well-defined
        padc = k - n_cand
        d = jnp.concatenate([d, jnp.full((Q, padc), jnp.inf, d.dtype)], axis=1)
        cand_ids = jnp.concatenate(
            [cand_ids, jnp.full((Q, padc), -1, cand_ids.dtype)], axis=1
        )
    vals, out_ids = smallest_k_unique(d, cand_ids, k, max_dup=max_dup)
    out_ids = jnp.where(jnp.isfinite(vals), out_ids, -1)
    return out_ids, vals


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "nprobe", "pad", "metric", "prune", "max_dup", "probe_chunk"
    ),
)
def _search_kernel_probe_chunked(
    queries,
    centroids,
    cent_valid,
    offsets,
    lens,
    ids,
    vectors,
    scales,
    prune_factor,
    *,
    k: int,
    nprobe: int,
    pad: int,
    metric: str,
    prune: bool,
    max_dup: int = 8,
    probe_chunk: int = 64,
    q_scales=None,  # (Q, 1) f32 when queries are int8 codes
):
    """XLA-engine search consuming the probe axis in fixed chunks.

    The plain kernel's candidate gather is O(Q * nprobe * pad * d) — a
    full-probe search at 1M scale asks XLA for a 157 GB fusion output.
    Here an internal fori_loop gathers ``probe_chunk`` postings at a time
    and folds them into a running top-(k * max_dup) candidate set per
    query, which provably contains the k distinct winners (the k-th
    distinct id sits at raw-distance rank <= k * max_dup, the structural
    replication bound), so the final bounded-dedup top-k is exact."""
    Q = queries.shape[0]
    if q_scales is not None:  # int8 query wire: dequantize on device
        queries = queries.astype(jnp.float32) * q_scales
    qf = queries.astype(centroids.dtype)
    cent_d, cent_i = centroid_topk(qf, centroids, cent_valid, nprobe, metric)
    n_chunks = (nprobe + probe_chunk - 1) // probe_chunk
    np_pad = n_chunks * probe_chunk
    cent_d_p = jnp.pad(
        cent_d, ((0, 0), (0, np_pad - nprobe)), constant_values=jnp.inf
    )
    cent_i_p = jnp.pad(cent_i, ((0, 0), (0, np_pad - nprobe)))
    thr = (
        prune_factor.astype(ACCUM_DTYPE) * (cent_d[:, 0] + _F32_EPS)
        if prune else None
    )
    ar = jnp.arange(pad, dtype=jnp.int32)
    kk = max(k, min(k * max_dup, np_pad * pad))

    def body(ci, state):
        best_d, best_i = state
        cd = jax.lax.dynamic_slice(cent_d_p, (0, ci * probe_chunk), (Q, probe_chunk))
        cii = jax.lax.dynamic_slice(cent_i_p, (0, ci * probe_chunk), (Q, probe_chunk))
        base = offsets[cii].astype(jnp.int32)
        pos = base[..., None] + ar
        valid = (ar < lens[cii][..., None]) & jnp.isfinite(cd)[..., None]
        pos = jnp.clip(pos, 0, vectors.shape[0] - 1)
        cv = vectors[pos]
        if vectors.dtype == jnp.int8:
            cv = (
                cv.astype(ACCUM_DTYPE) * scales[cii][..., None, None]
                + centroids[cii].astype(ACCUM_DTYPE)[:, :, None, :]
            )
        d = rowwise_distance(cv, queries[:, None, None, :], metric)
        d = jnp.where(valid, d, jnp.inf)
        if prune:
            d = jnp.where(d <= thr[:, None, None], d, jnp.inf)
        cid = jnp.where(valid, ids[pos], -1)
        cat_d = jnp.concatenate([best_d, d.reshape(Q, probe_chunk * pad)], axis=1)
        cat_i = jnp.concatenate([best_i, cid.reshape(Q, probe_chunk * pad)], axis=1)
        vals, idx = smallest_k(cat_d, kk)
        return vals, jnp.take_along_axis(cat_i, idx, axis=1)

    init = (
        jnp.full((Q, kk), jnp.inf, jnp.float32),
        jnp.full((Q, kk), -1, ids.dtype),
    )
    best_d, best_i = jax.lax.fori_loop(0, n_chunks, body, init)
    vals, out_ids = smallest_k_unique(best_d, best_i, k, max_dup=max_dup)
    out_ids = jnp.where(jnp.isfinite(vals), out_ids, -1)
    return out_ids, vals


@functools.partial(
    jax.jit,
    static_argnames=("k", "nprobe", "pad", "metric", "prune", "max_dup"),
)
def _search_kernel_padded(
    queries,
    centroids,
    cent_valid,
    lens,
    ids2d,
    vectors3d,
    scales,
    prune_factor,
    *,
    k: int,
    nprobe: int,
    pad: int,
    metric: str,
    prune: bool,
    max_dup: int = 8,
    q_scales=None,  # (Q, 1) f32 when queries are int8 codes
):
    """Slab-layout search: centroid scan, gather + rerank of whole posting
    slabs (``slab_distances``), then masked global top-k with replica
    dedup."""
    Q = queries.shape[0]
    if q_scales is not None:  # int8 query wire: dequantize on device
        queries = queries.astype(jnp.float32) * q_scales
    qf = queries.astype(centroids.dtype)
    cent_d, rows = centroid_topk(qf, centroids, cent_valid, nprobe, metric)
    rows = rows.astype(jnp.int32)
    if vectors3d.dtype == jnp.int8:
        # IVF-SQ8 distance vs residual codes: |s*r - (q - c)| — the rerank
        # sees per-(query, probe) CENTERED queries plus the scale table.
        qc = (
            queries.astype(jnp.float32)[:, None, :]
            - centroids[rows].astype(jnp.float32)
        )  # (Q, nprobe, d_pad)
        d = slab_distances(
            queries, rows, vectors3d, metric,
            scales=scales[rows], centered_queries=qc,
        )
    else:
        d = slab_distances(queries, rows, vectors3d, metric)  # (Q, nprobe, pad)
    ar = jnp.arange(pad, dtype=jnp.int32)
    valid = (ar < lens[rows][..., None]) & jnp.isfinite(cent_d)[..., None]
    cand_ids = jnp.where(valid, ids2d[rows], -1)
    d = jnp.where(valid, d, jnp.inf)
    if prune:
        thr = prune_factor.astype(ACCUM_DTYPE) * (cent_d[:, 0] + _F32_EPS)
        d = jnp.where(d <= thr[:, None, None], d, jnp.inf)
    n_cand = nprobe * pad
    d = d.reshape(Q, n_cand)
    cand_ids = cand_ids.reshape(Q, n_cand)
    if n_cand < k:
        padc = k - n_cand
        d = jnp.concatenate([d, jnp.full((Q, padc), jnp.inf, d.dtype)], axis=1)
        cand_ids = jnp.concatenate(
            [cand_ids, jnp.full((Q, padc), -1, cand_ids.dtype)], axis=1
        )
    vals, out_ids = smallest_k_unique(d, cand_ids, k, max_dup=max_dup)
    out_ids = jnp.where(jnp.isfinite(vals), out_ids, -1)
    return out_ids, vals


def _cast_storage_np(x, sd, scale: float) -> np.ndarray:
    """Host-side cast of f32 member rows into the storage dtype.  int8
    quantizes with the per-index scale (see core.dtypes); float dtypes are a
    plain astype (ml_dtypes registers bfloat16 with numpy)."""
    if jnp.dtype(sd) == jnp.int8:
        return quantize_np(x, scale)
    return np.asarray(x).astype(sd)


def _q_dev(x, sd, inv_scale):
    """Device-side storage cast (static branch on the storage dtype; the
    quantizing multiply is a traced scalar — no recompile per scale)."""
    if jnp.dtype(sd) == jnp.int8:
        return jnp.clip(
            jnp.round(x.astype(jnp.float32) * inv_scale), -127, 127
        ).astype(jnp.int8)
    return x.astype(sd)


@functools.partial(
    jax.jit, static_argnames=("d", "Cpad", "pad", "d_pad", "sd", "n_chunks")
)
def _pack_from_corpus_fused(
    corpus, rows2d, slots2d, flat_ids_pad, cent_d32, d: int,
    Cpad: int, pad: int, d_pad: int, sd, n_chunks: int,
):
    """Whole pack as ONE program: an internal fori_loop gathers each
    (CH,)-row chunk from the corpus and scatters it at its flat slab slots,
    so XLA keeps a single slab buffer in place instead of allocating a
    fresh multi-GB generation per chunk call.  Chunk padding repeats real
    entries — idempotent same-value rewrites."""

    quant = jnp.dtype(sd) == jnp.int8
    if quant:
        # Pass 1: per-POSTING abs-maxima of the RESIDUALS x - centroid
        # (slot // pad = slab row), then the IVF-SQ8 scales
        # s_c = resmax_c / 127 (empty/zero postings -> 1.0): the
        # quantization step tracks the CLUSTER RADIUS, not the coordinate
        # magnitude.  Same f32 expressions as the host pack — packs from
        # either side are bit-identical.
        def mbody(i, m):
            r = jax.lax.dynamic_index_in_dim(rows2d, i, keepdims=False)
            s = jax.lax.dynamic_index_in_dim(slots2d, i, keepdims=False)
            res = corpus[r].astype(jnp.float32) - cent_d32[s // pad]
            return m.at[s // pad].max(jnp.max(jnp.abs(res), axis=1))

        rowmax = jax.lax.fori_loop(
            0, n_chunks, mbody, jnp.zeros((Cpad,), jnp.float32)
        )
        scales = jnp.where(
            rowmax > 0, rowmax * jnp.float32(1.0 / 127.0), jnp.float32(1.0)
        )
        inv = jnp.float32(1.0) / scales
    else:
        scales = jnp.ones((Cpad,), jnp.float32)
        inv = scales

    def body(i, v):
        r = jax.lax.dynamic_index_in_dim(rows2d, i, keepdims=False)
        s = jax.lax.dynamic_index_in_dim(slots2d, i, keepdims=False)
        x = corpus[r]
        if quant:
            res = x.astype(jnp.float32) - cent_d32[s // pad]
            x = _q_dev(res, sd, inv[s // pad][:, None])
        else:
            x = x.astype(v.dtype)
        return v.at[s, :d].set(x)

    v = jax.lax.fori_loop(
        0, n_chunks, body, jnp.zeros((Cpad * pad, d_pad), sd)
    )
    i = (
        jnp.full((Cpad * pad,), -1, jnp.int32)
        .at[slots2d.reshape(-1)].set(flat_ids_pad)
        .reshape(Cpad, pad)
    )
    return v.reshape(Cpad, pad, d_pad), i, scales


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("d",))
def _scatter_flat_chunk(v, vec_chunk, slots, d: int):
    return v.at[slots, :d].set(vec_chunk.astype(v.dtype))


_PACK_CHUNK = 1 << 18  # member rows per pack step (bounds the gather at
# ~256 MB f32 @ 960-d; the full-P gather peaked ~6 GB at 1M x 960 and OOMed
# next to the slab array + corpus)


def _chunk_slices(n: int, chunk: int):
    """(start, end, tail_pad) triples covering [0, n) in ``chunk`` pieces;
    only the LAST piece may need padding (callers pad that slice alone with
    repeats of its first element — idempotent rewrites — instead of copying
    the whole multi-GB host array to a chunk multiple)."""
    for s0 in range(0, max(n, 1), chunk):
        e = min(s0 + chunk, n)
        yield s0, e, chunk - (e - s0)


def _pad_tail(arr_slice: np.ndarray, tail: int) -> np.ndarray:
    if tail == 0:
        return arr_slice
    return np.concatenate([arr_slice, np.repeat(arr_slice[:1], tail, axis=0)])


def _pack_slabs_from_corpus(
    corpus, rows, flat_ids, slots, cent_np, Cpad: int, pad: int, d_pad: int,
    sd: str,
):  # noqa: D401 — see _pack_from_corpus_fused for the device program
    """Slab pack with ZERO vector upload: the corpus is already device-
    resident from the clustering phase and a fresh build's member vectors are
    corpus rows, so the host sends only the int32 row/slot/id arrays (~1% of
    the member bytes) and the gather + dtype cast + scatter all run on-chip.
    Turns the view materialization from an H2D-bandwidth problem into a
    sub-second HBM shuffle.

    Chunked INSIDE one program: the member gather runs in fixed-size pieces
    via an internal fori_loop, so peak HBM is slabs + corpus + one chunk —
    not slabs + corpus + a full (P, d) gather — and the slab buffer is
    allocated exactly once (see _pack_from_corpus_fused)."""
    d = corpus.shape[1]
    rows = np.asarray(rows, np.int32)
    slots_np = np.asarray(slots, np.int32)
    P = rows.shape[0]
    n_chunks = max(1, (P + _PACK_CHUNK - 1) // _PACK_CHUNK)
    rows2d = np.empty((n_chunks, _PACK_CHUNK), np.int32)
    slots2d = np.empty((n_chunks, _PACK_CHUNK), np.int32)
    ids_pad = np.empty(n_chunks * _PACK_CHUNK, flat_ids.dtype)
    for ci, (s0, e, tail) in enumerate(_chunk_slices(P, _PACK_CHUNK)):
        rows2d[ci] = _pad_tail(rows[s0:e], tail)
        slots2d[ci] = _pad_tail(slots_np[s0:e], tail)
        ids_pad[ci * _PACK_CHUNK : (ci + 1) * _PACK_CHUNK] = _pad_tail(
            np.asarray(flat_ids)[s0:e], tail
        )
    from spfresh_tpu.utils.xfer import timed_put

    return _pack_from_corpus_fused(
        corpus, timed_put(rows2d), timed_put(slots2d),
        timed_put(ids_pad),
        timed_put(np.ascontiguousarray(cent_np[:, :d], np.float32)), d,
        Cpad=Cpad, pad=pad, d_pad=d_pad, sd=sd, n_chunks=n_chunks,
    )


@functools.partial(jax.jit, static_argnames=("Ppad", "Cpad", "sd"))
def _flat_from_corpus(corpus, rows, row_seg, cent_d32, Ppad: int, Cpad: int,
                      sd: str):
    """CSR flat pack from the device corpus.  ``row_seg`` maps each flat
    member position to its posting row.  int8 stores per-posting-scaled
    RESIDUALS x - centroid (IVF-SQ8).  Returns (vectors (Ppad, d) storage
    dtype, scales (Cpad,) f32)."""
    x = corpus[rows].astype(jnp.float32)
    if jnp.dtype(sd) == jnp.int8:
        res = x - cent_d32[row_seg]
        rowmax = jax.ops.segment_max(
            jnp.max(jnp.abs(res), axis=1), row_seg, num_segments=Cpad
        )
        rowmax = jnp.maximum(rowmax, 0.0)  # empty segments return -inf
        scales = jnp.where(
            rowmax > 0, rowmax * jnp.float32(1.0 / 127.0), jnp.float32(1.0)
        )
        inv = jnp.float32(1.0) / scales
        v = _q_dev(res, sd, inv[row_seg][:, None])
    else:
        scales = jnp.ones((Cpad,), jnp.float32)
        v = x.astype(sd)
    return jnp.pad(v, ((0, Ppad - v.shape[0]), (0, 0))), scales


def _host_posting_scales(flat_vecs, row_seg, Cpad: int) -> np.ndarray:
    """Host mirror of the device per-posting scale computation (exact
    maxima + identical f32 expressions -> bit-identical scales)."""
    from spfresh_tpu.core.dtypes import posting_scales_np

    rowmax = np.zeros(Cpad, np.float32)
    if len(row_seg):
        np.maximum.at(
            rowmax, row_seg,
            np.max(np.abs(np.asarray(flat_vecs, np.float32)), axis=1),
        )
    return posting_scales_np(rowmax)


def _pack_slabs(flat_vecs, flat_ids, slots, cent_np, Cpad: int, pad: int,
                d_pad: int, sd):
    """Device-side slab pack from HOST member rows: upload + scatter in
    fixed-size chunks against the donated slab buffer.  The host sends only
    the raw (P, d) vectors in the storage dtype — no padding bytes cross the
    wire — and peak HBM is slabs + one chunk, never slabs + a second full
    flat copy."""
    from spfresh_tpu.utils.xfer import timed_put

    flat_vecs = np.asarray(flat_vecs)
    d = flat_vecs.shape[1]
    slots_np = np.asarray(slots, np.int32)
    if jnp.dtype(sd) == jnp.int8:
        seg = slots_np // pad
        flat_vecs = (
            np.asarray(flat_vecs, np.float32) - cent_np[seg, :d]
        )  # residuals
        scales_np = _host_posting_scales(flat_vecs, seg, Cpad)
        row_scale = scales_np[seg][:, None]
    else:
        scales_np = np.ones(Cpad, np.float32)
        row_scale = None
    v = jnp.zeros((Cpad * pad, d_pad), sd)
    for s0, e, tail in _chunk_slices(slots_np.shape[0], _PACK_CHUNK):
        chunk = _pad_tail(flat_vecs[s0:e], tail)
        sc = (
            _pad_tail(row_scale[s0:e], tail) if row_scale is not None else 1.0
        )
        v = _scatter_flat_chunk(
            v,
            timed_put(_cast_storage_np(chunk, sd, sc)),
            timed_put(_pad_tail(slots_np[s0:e], tail)),
            d,
        )
    i = (
        jnp.full((Cpad * pad,), -1, jnp.int32)
        .at[jnp.asarray(slots_np)].set(flat_ids)
        .reshape(Cpad, pad)
    )
    return v.reshape(Cpad, pad, d_pad), i, jnp.asarray(scales_np)


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _scatter_appends(vectors3d, ids2d, slots, vblk, iblk):
    """Row-level append scatter: write B new member rows at their flat slab
    slots (row * pad + position).  The upload is O(B * d_pad) — the appended
    vectors only — not whole slabs.  Duplicate slots (chunk padding) carry
    identical rows."""
    C, pad, dp = vectors3d.shape
    v = vectors3d.reshape(C * pad, dp).at[slots].set(vblk).reshape(C, pad, dp)
    i = ids2d.reshape(C * pad).at[slots].set(iblk).reshape(C, pad)
    return v, i


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_lens(lens, rows, new_lens):
    return lens.at[rows].set(new_lens)


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4, 5))
def _scatter_rows(vectors3d, ids2d, lens, cents, valid, scales,
                  rows, vblk, iblk, lblk, cblk, vldblk, sblk):
    """In-place slab update: scatter B dirty postings' blocks into the view
    arrays.  Donated buffers — XLA updates HBM in place, so the cost is the
    (B, pad, d_pad) upload, not a re-materialization of the whole view.
    Duplicate rows (batch padding) carry identical blocks, so scatter order
    does not matter."""
    return (
        vectors3d.at[rows].set(vblk),
        ids2d.at[rows].set(iblk),
        lens.at[rows].set(lblk),
        cents.at[rows].set(cblk),
        valid.at[rows].set(vldblk),
        scales.at[rows].set(sblk),
    )


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _brute_force_kernel(corpus, queries, k: int, metric: str):
    D = pairwise_distance(queries.astype(corpus.dtype), corpus, metric, exact=True)
    return smallest_k(D, k)


@functools.partial(jax.jit, static_argnames=("k", "kc", "metric", "chunk"))
def _brute_force_2stage_kernel(corpus, queries, k: int, kc: int, metric: str, chunk: int = 65536):
    """Large-corpus exact top-k: fast matmul-expansion scan selects kc candidates, the
    elementwise-exact form reranks them.  Exact as long as the true top-k
    survive the ~1e-3-relative-error prefilter into the top-kc (kc >> k).

    The corpus is scanned in ``chunk``-row pieces with a running top-kc merge
    — ``lax.top_k`` over millions of columns at once is far slower than
    chunked selection, and the (Q, n) distance matrix never materializes."""
    n, d = corpus.shape
    Q = queries.shape[0]
    qf = queries.astype(corpus.dtype)
    chunk = min(chunk, n)
    n_chunks = (n + chunk - 1) // chunk
    pad_n = n_chunks * chunk
    corpus_p = jnp.pad(corpus, ((0, pad_n - n), (0, 0)))

    def body(i, state):
        best_d, best_i = state
        start = i * chunk
        block = jax.lax.dynamic_slice(corpus_p, (start, 0), (chunk, d))
        D = pairwise_distance(qf, block, metric)  # (Q, chunk) fast path
        col = start + jax.lax.broadcasted_iota(jnp.int32, (Q, chunk), 1)
        D = jnp.where(col < n, D, jnp.inf)
        cat_d = jnp.concatenate([best_d, D], axis=1)
        cat_i = jnp.concatenate([best_i, col], axis=1)
        vals, idx = smallest_k(cat_d, kc)
        return vals, jnp.take_along_axis(cat_i, idx, axis=1)

    init = (jnp.full((Q, kc), jnp.inf), jnp.zeros((Q, kc), jnp.int32))
    best_d, cand = jax.lax.fori_loop(0, n_chunks, body, init)
    cand_vecs = corpus[cand]  # (Q, kc, d)
    d_exact = rowwise_distance(cand_vecs, qf[:, None, :], metric)
    vals, idx = smallest_k(d_exact, k)
    return vals, jnp.take_along_axis(cand, idx, axis=-1)


def brute_force_search(
    corpus, queries, k: int, metric: str = "Euclidean", batch_size: int = 1024
):
    """Exact top-k ground truth (used by the recall harness and tests).

    Below ~100k rows the fully-elementwise exact kernel is used; above, a
    two-stage scan (matmul prefilter to 32*k candidates + exact rerank) keeps
    the broadcast intermediates bounded."""
    metric = canonical_metric(metric)
    corpus = jnp.asarray(corpus)
    k = min(int(k), int(corpus.shape[0]))
    out_d, out_i = [], []
    queries = np.asarray(queries)
    # The fully-elementwise exact form broadcasts (tile, n, d) — past ~10k
    # rows that intermediate thrashes device memory; the chunked scan keeps
    # memory bounded for every metric.  Euclidean oversamples kc through the
    # fast matmul prefilter then reranks exactly; Manhattan/Chebyshev blocks are
    # already exact, so kc == k and the rerank is a no-op check.
    big = corpus.shape[0] > 10_000
    if metric == "Euclidean":
        kc = min(max(32 * k, 256), corpus.shape[0])
        chunk = 65536
    else:
        kc = k
        # Elementwise blocks re-read the block per query tile: keep blocks
        # small so the (q_tile, chunk, d) fusion stays within budget.
        chunk = 8192
    for s in range(0, queries.shape[0], batch_size):
        qb = jnp.asarray(queries[s : s + batch_size])
        if big:
            d, i = _brute_force_2stage_kernel(corpus, qb, k, kc, metric, chunk)
        else:
            d, i = _brute_force_kernel(corpus, qb, k, metric)
        out_d.append(np.asarray(d))
        out_i.append(np.asarray(i))
    return np.concatenate(out_d), np.concatenate(out_i)


# ---------------------------------------------------------------------------
# Device view (compiled snapshot of the posting state)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceView:
    centroids: jnp.ndarray  # (Cpad, d) storage dtype (f32 for int8 slabs)
    cent_valid: jnp.ndarray  # (Cpad,) bool
    offsets: jnp.ndarray  # (Cpad,) int32 — start of each cluster's slice
    lens: jnp.ndarray  # (Cpad,) int32
    ids: jnp.ndarray  # (Ppad,) int32 (-1 = padding; int64 on host/storage)
    vectors: jnp.ndarray  # (Ppad, d) storage dtype
    scales: jnp.ndarray  # (Cpad,) f32 per-posting dequant scales (1.0 = none)
    pad: int  # static per-cluster gather width (>= max posting length)
    cluster_rows: Dict[int, int]  # cluster_id -> row in the padded arrays
    max_dup: int = 8  # max multiplicity of any point id across postings


@dataclasses.dataclass
class PaddedView:
    """Slab layout of the "slab" search engine: every posting list is one
    contiguous (pad, d_pad) block of a (Cpad, pad, d_pad) device array, so
    the rerank reads whole slabs, not element gathers.  d is zero-padded to
    a multiple of 128; zeros cancel in every metric because queries are
    padded identically.

    The view is update-in-place: ``free_rows`` are the unoccupied slab rows
    (Cpad headroom) that incremental updates assign to postings created by
    live inserts/splits, and mutated postings scatter into their existing
    rows — no full repack/re-upload per update batch (SPFresh's point)."""

    centroids: jnp.ndarray  # (Cpad, d_pad)
    cent_valid: jnp.ndarray  # (Cpad,)
    lens: jnp.ndarray  # (Cpad,) int32
    ids2d: jnp.ndarray  # (Cpad, pad) int32 (-1 = padding)
    vectors3d: jnp.ndarray  # (Cpad, pad, d_pad) storage dtype
    scales: jnp.ndarray  # (Cpad,) f32 per-posting dequant scales (1.0 = none)
    pad: int
    d_pad: int
    cluster_rows: Dict[int, int]
    max_dup: int = 8
    free_rows: List[int] = dataclasses.field(default_factory=list)
    # cid -> the ids array its slab held at the last refresh.  Lets the next
    # refresh recognize pure appends (the streaming-insert common case) and
    # upload ONLY the appended rows instead of whole slabs.
    snapshot: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    # Host mirror of `scales` for the incremental-update quantize paths
    # (pulled lazily; rewrites keep it in sync).
    scales_host: Optional[np.ndarray] = None


class _LazyMemberVecs:
    """Posting member vectors materialized on first touch from the build
    corpus (``corpus[ids]``).

    The bulk-build host gather of every replica row (~1.6 GB / ~9 s on the
    1-core host at 1M x 128 x 3.2 replication) is pure waste when the first
    device view packs straight from the device-resident corpus — nothing
    host-side ever reads the vectors.  Steady-state update/save paths touch
    a handful of postings and pay only their own slices.  Quacks like the
    ndarray it stands for: ``np.asarray``/``np.concatenate`` hit
    ``__array__``, slicing materializes, and unknown attributes delegate to
    the materialized array."""

    __slots__ = ("_corpus", "_ids", "_mat")

    def __init__(self, corpus: np.ndarray, ids: np.ndarray):
        self._corpus = corpus
        self._ids = ids
        self._mat = None

    def _m(self) -> np.ndarray:
        if self._mat is None:
            self._mat = self._corpus[self._ids]
        return self._mat

    def peek(self) -> np.ndarray:
        """Materialize WITHOUT caching — for streaming consumers (save)
        that touch every posting once: caching there would accumulate the
        whole replicated corpus in RAM."""
        return self._mat if self._mat is not None else self._corpus[self._ids]

    def __array__(self, dtype=None, copy=None):
        m = self._m()
        return m if dtype is None else m.astype(dtype, copy=False)

    def __len__(self) -> int:
        return len(self._ids)

    def __getitem__(self, key):
        return self._m()[key]

    def __getattr__(self, name):
        return getattr(self._m(), name)

    @property
    def shape(self):
        return (len(self._ids), self._corpus.shape[1])

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self):
        return self._corpus.dtype


class SpannIndex:
    """Mirror of SpannIndex (spann_index.rs:17-21) with batched search and
    mutable posting state for SPFresh updates."""

    def __init__(self, config: Optional[Config] = None):
        self.config = config or Config()
        self.metric = canonical_metric(self.config.distance_metric)
        self.policy = DtypePolicy(self.config.storage_dtype)
        self.dim: Optional[int] = None
        # Canonical state: cluster_id -> (ids int64 (m,), vectors f32 (m, d)).
        self.postings: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        # cluster_id -> centroid vector f32 (d,)
        self.centroids: Dict[int, np.ndarray] = {}
        self._next_cluster_id = 0
        self._view: Optional[DeviceView] = None
        self._padded_view: Optional[PaddedView] = None
        self._gen = 0  # bumped on every mutation; views cache their build gen
        self._view_gen = -1
        self._padded_gen = -1
        # Cluster ids mutated since the padded view was built; None means the
        # change was structural (bulk load) and the next view is a full pack.
        self._dirty_padded: Optional[set] = set()
        # Mutation journal for EXTERNAL views (e.g. the sharded padded view):
        # cid -> gen of its last mutation, plus the gen of the last bulk /
        # structural change.  A view that cached gen g refreshes exactly the
        # cids with _mutated_gen > g, or fully rebuilds when _bulk_gen > g.
        self._mutated_gen: Dict[int, int] = {}
        self._centroid_gen: Dict[int, int] = {}  # cid -> gen of last centroid change
        self._bulk_gen = 0
        # Subset of dirty cids whose CENTROID changed (append fast path must
        # not skip the centroid row for those).
        self._dirty_centroid: set = set()
        # (gen, all_ids, all_vecs) from a bulk load, for the first view pack.
        self._flat_cache = None
        # (gen, device corpus) from the build, for zero-upload view packing.
        self._corpus_cache = None
        # Largest known replica multiplicity of any point id.  Full packs
        # compute it exactly; live updates that raise it (boundary-closure
        # splits, reassign windows) report through note_multiplicity so the
        # dedup oversampling bound stays an upper bound between packs.
        self._mult_hint = 1

    def note_multiplicity(self, m: int) -> None:
        self._mult_hint = max(self._mult_hint, int(m))

    def _dedup_bound(self) -> int:
        # +1 margin: a Reassign's copy-before-delete window can raise one
        # id's multiplicity transiently; pow2 bucketing keeps the kernels'
        # static max_dup stable across incremental updates.
        return _next_pow2(self._mult_hint + 1)

    def _mark_dirty(self, cluster_id: int) -> None:
        self._gen += 1
        self._corpus_cache = None  # release the build corpus's HBM
        self._mutated_gen[cluster_id] = self._gen
        if cluster_id in self._dirty_centroid:
            # May over-mark when an old centroid-dirty flag is still pending —
            # that only disqualifies an append fast path, never correctness.
            self._centroid_gen[cluster_id] = self._gen
        if self._dirty_padded is not None:
            self._dirty_padded.add(cluster_id)

    # -- construction ------------------------------------------------------

    def create_posting_lists(
        self, clusters, data: np.ndarray, corpus_dev=None,
        lazy_host: bool = False,
    ) -> None:
        """From fitted clusters (create_posting_lists, spann_index.rs:56-84).
        One bulk gather + split instead of a per-cluster copy loop (the loop
        costs ~10 s at 12k clusters on a 1-core host).

        ``corpus_dev``: the clustering phase's device-resident corpus.  When
        given, the first device view gathers member vectors from it ON-CHIP
        instead of re-uploading them from the host.

        ``lazy_host``: keep member vectors as lazy views over the HOST
        corpus even without a device corpus (out-of-core builds: the corpus
        may not fit in RAM twice, let alone HBM)."""
        data = np.asarray(data, dtype=np.float32)
        self.dim = data.shape[1]
        all_ids = np.concatenate([np.asarray(c.points, np.int64) for c in clusters])             if clusters else np.empty(0, np.int64)
        first_cid = self._next_cluster_id
        fresh = first_cid == 0
        corpus_ok = corpus_dev is not None and corpus_dev.shape[0] > (
            int(all_ids.max()) if all_ids.size else -1
        )
        # When the first view will pack from the device-resident corpus,
        # nothing host-side reads the member vectors — defer the ~GB host
        # gather (point id == corpus row in a bulk build) to first touch.
        lazy = fresh and (corpus_ok or lazy_host)
        all_vecs = _LazyMemberVecs(data, all_ids) if lazy else data[all_ids]
        pos = 0
        for c in clusters:
            m = len(c.points)
            cid = self._next_cluster_id
            self._next_cluster_id += 1
            ids_c = all_ids[pos : pos + m]
            vecs_c = _LazyMemberVecs(data, ids_c) if lazy else all_vecs[pos : pos + m]
            self.postings[cid] = (ids_c, vecs_c)
            self.centroids[cid] = data[c.centroid_idx].copy()
            pos += m
        self._gen += 1
        self._dirty_padded = None  # bulk load: next view is a full pack
        self._bulk_gen = self._gen
        # The flat concatenation IS the view pack's input — cache it so the
        # first view build skips a multi-GB re-concat on the 1-core host.
        if fresh and len(self.postings) == len(clusters):
            self._flat_cache = (self._gen, all_ids, all_vecs)
            if corpus_ok:
                self._corpus_cache = (self._gen, corpus_dev)

    def _as_posting_vecs(self, ids, vectors) -> np.ndarray:
        vectors = np.asarray(vectors, np.float32)
        if len(ids) == 0:
            # reshape(0, -1) cannot infer the trailing dim on empty input.
            return vectors.reshape(0, self.dim or (vectors.shape[-1] if vectors.ndim > 1 else 0))
        return vectors.reshape(len(ids), -1)

    def add_cluster(self, vectors: np.ndarray, ids: np.ndarray, centroid: np.ndarray) -> int:
        cid = self._next_cluster_id
        self._next_cluster_id += 1
        vectors = self._as_posting_vecs(ids, vectors)
        if self.dim is None:
            self.dim = vectors.shape[1]
        self.postings[cid] = (np.asarray(ids, np.int64), vectors)
        self.centroids[cid] = np.asarray(centroid, np.float32)
        self._dirty_centroid.add(cid)
        self._mark_dirty(cid)
        return cid

    def remove_cluster(self, cluster_id: int) -> None:
        self.postings.pop(cluster_id, None)
        self.centroids.pop(cluster_id, None)
        self._dirty_centroid.add(cluster_id)
        self._mark_dirty(cluster_id)

    def replace_posting(self, cluster_id: int, ids: np.ndarray, vectors: np.ndarray,
                        centroid: Optional[np.ndarray] = None) -> None:
        self.postings[cluster_id] = (
            np.asarray(ids, np.int64),
            self._as_posting_vecs(ids, vectors),
        )
        if centroid is not None:
            centroid = np.asarray(centroid, np.float32)
            # Only an actual centroid CHANGE disqualifies the append fast
            # path (mirror syncs re-pass the unchanged centroid every time).
            if not np.array_equal(self.centroids.get(cluster_id), centroid):
                self._dirty_centroid.add(cluster_id)
            self.centroids[cluster_id] = centroid
        self._mark_dirty(cluster_id)

    @property
    def num_clusters(self) -> int:
        return len(self.postings)

    @property
    def num_vectors(self) -> int:
        """Total stored vectors including boundary replicas."""
        return sum(len(ids) for ids, _ in self.postings.values())

    # -- device view -------------------------------------------------------

    def drop_device_views(self) -> None:
        """Release all device-resident caches (CSR view, padded slab view,
        build-corpus cache).  Host posting state is untouched; the next
        search repacks.  Use when an index is done serving (e.g. benchmark
        loops building many indexes) to return its HBM before the next
        allocation."""
        self._view = None
        self._padded_view = None
        self._view_gen = -1
        self._padded_gen = -1
        self._corpus_cache = None
        self._flat_cache = None

    def device_view(self) -> DeviceView:
        if self._view is not None and self._view_gen == self._gen:
            return self._view
        if not self.postings:
            raise ValueError("index is empty")
        d = self.dim
        cids = sorted(self.postings)
        C = len(cids)
        Cpad = max(8, _round_up(C, 256))
        max_len = max(len(self.postings[c][0]) for c in cids)
        pad = max(8, _round_up(max(1, max_len), 8))
        lens = np.zeros(Cpad, np.int32)
        offsets = np.zeros(Cpad, np.int32)
        cent = np.zeros((Cpad, d), np.float32)
        valid = np.zeros(Cpad, bool)
        P = sum(len(self.postings[c][0]) for c in cids)
        Ppad = max(8, _round_up(P, 8))
        flat_ids = np.full(Ppad, -1, np.int32)
        cluster_rows: Dict[int, int] = {}
        # Vectorized packing: per-cluster python loops cost tens of seconds
        # at 10k+ clusters; concatenate + one bulk copy is C-speed.
        lens_l = np.array([len(self.postings[c][0]) for c in cids], np.int64)
        offs_l = np.zeros(C + 1, np.int64)
        np.cumsum(lens_l, out=offs_l[1:])
        offsets[:C] = offs_l[:C]
        lens[:C] = lens_l
        valid[:C] = True
        cent[:C] = np.stack([self.centroids[c] for c in cids]) if cids else cent[:0]
        if self._flat_cache is not None and self._flat_cache[0] == self._gen:
            all_ids_f, all_vecs_f = self._flat_cache[1], self._flat_cache[2]
        else:
            all_ids_f = np.concatenate([self.postings[c][0] for c in cids]) if cids else np.empty(0, np.int64)
            all_vecs_f = np.concatenate([self.postings[c][1] for c in cids]) if cids else np.empty((0, d), np.float32)
        flat_ids[:P] = _ids_i32(all_ids_f)
        sd = self.policy.storage_dtype
        row_seg = np.repeat(np.arange(C, dtype=np.int32), lens_l)
        if self._corpus_cache is not None and self._corpus_cache[0] == self._gen and P:
            # Zero-upload: gather member vectors from the device corpus.
            from spfresh_tpu.utils.xfer import timed_put as _tp

            vectors_dev, scales_dev = _flat_from_corpus(
                self._corpus_cache[1], jnp.asarray(flat_ids[:P]),
                jnp.asarray(row_seg),
                _tp(np.ascontiguousarray(cent[:, :d], np.float32)),
                Ppad=Ppad, Cpad=Cpad, sd=sd,
            )
        else:
            flat_vecs = np.zeros((Ppad, d), np.float32)
            flat_vecs[:P] = all_vecs_f
            if self.policy.quantized:
                res = flat_vecs[:P] - cent[row_seg, :d]  # residuals
                scales_np = _host_posting_scales(res, row_seg, Cpad)
                flat_q = np.zeros((Ppad, d), np.int8)
                flat_q[:P] = quantize_np(res, scales_np[row_seg][:, None])
                vectors_dev = jnp.asarray(flat_q)
            else:
                scales_np = np.ones(Cpad, np.float32)
                vectors_dev = jnp.asarray(flat_vecs, sd)
            scales_dev = jnp.asarray(scales_np)
        for row, c in enumerate(cids):
            cluster_rows[c] = row
        self._view = DeviceView(
            centroids=self._cast_centroids(cent),
            cent_valid=jnp.asarray(valid),
            offsets=jnp.asarray(offsets),
            lens=jnp.asarray(lens),
            ids=jnp.asarray(flat_ids),
            vectors=vectors_dev,
            scales=scales_dev,
            pad=pad,
            cluster_rows=cluster_rows,
            max_dup=self._refresh_mult(flat_ids[:P]),
        )
        self._view_gen = self._gen
        self._hbm_guard(int(vectors_dev.size) * vectors_dev.dtype.itemsize)
        return self._view

    def _refresh_mult(self, all_ids: np.ndarray) -> int:
        self._mult_hint = max(self._mult_hint, _max_multiplicity(all_ids))
        return self._dedup_bound()

    def _append_scale_ok(self, view, row: int, c: int, vecs, old_len: int) -> bool:
        """int8 append-fast-path admission: appended members quantize with
        the slab's EXISTING scale, so the fast path is only exact when a
        full rebuild would keep that scale — i.e. the appended residuals
        stay within the slab's current abs-max.  Since posting_scales_np is
        monotone, f(max(old, new)) == max(s_old, f(new)) EXACTLY, so the
        check is f(new_max) <= s_old.  A slab at the 1.0 pin (empty or
        all-zero residuals) is demoted unconditionally — the pin hides the
        real abs-max.  Demotion (slab rewrite) is always exact, only
        costlier."""
        if not self.policy.quantized:
            return True
        from spfresh_tpu.core.dtypes import posting_scales_np

        sh = self._view_scales_host(view)
        s_old = float(sh[row])  # int row (1-D) or (shard, row) tuple (2-D)
        if s_old == 1.0:
            return False
        res = np.asarray(vecs)[old_len:] - self.centroids[c][None, :]
        new_max = np.float32(np.max(np.abs(res), initial=0.0))
        return float(posting_scales_np(np.array([new_max]))[0]) <= s_old

    @staticmethod
    def _view_scales_host(view) -> np.ndarray:
        """Host mirror of the view's per-posting dequant scales (one lazy
        pull; the rewrite path keeps it in sync)."""
        if view.scales_host is None:
            view.scales_host = np.asarray(view.scales).copy()
        return view.scales_host

    def _cast_centroids(self, cent: np.ndarray) -> jnp.ndarray:
        """Routing-tier upload.  int8 storage keeps centroids in f32 (real
        units): the stage-1 scan needs full routing precision, and the
        rerank dequantizes slabs per posting, so every distance in the
        engine is in real units."""
        if self.policy.quantized:
            return jnp.asarray(cent, jnp.float32)
        return jnp.asarray(cent, self.policy.storage_dtype)

    def padded_view(self) -> PaddedView:
        """Slab layout of the "slab" engine: (Cpad, pad, d_pad) with d_pad a
        multiple of 128 and pad a multiple of 16.

        After live updates the view refreshes INCREMENTALLY: only mutated
        postings' slabs are scattered into the donated device arrays (SPFresh
        in-place semantics) — a full repack happens only on bulk loads, when
        a posting outgrows its slab, or when the view runs out of spare rows."""
        if self._padded_view is not None and self._padded_gen == self._gen:
            return self._padded_view
        if (
            self._padded_view is not None
            and self._dirty_padded is not None
            and self._apply_padded_updates()
        ):
            self._padded_gen = self._gen
            self._dirty_padded = set()
            return self._padded_view
        if not self.postings:
            raise ValueError("index is empty")
        d = self.dim
        d_pad = max(128, _round_up(d, 128))
        cids = sorted(self.postings)
        C = len(cids)
        Cpad = max(8, _round_up(C, 256))
        max_len = max(len(self.postings[c][0]) for c in cids)
        # Growth slots let live inserts land in place without a repack.
        pad = max(16, _round_up(max(1, max_len) + self.config.search.slab_growth_slots, 16))
        if Cpad * pad >= np.iinfo(np.int32).max:
            raise ValueError("padded view exceeds int32 slot space; shard the index")
        lens = np.zeros(Cpad, np.int32)
        cent = np.zeros((Cpad, d_pad), np.float32)
        valid = np.zeros(Cpad, bool)
        cluster_rows: Dict[int, int] = {}
        # Flat member arrays + per-member slab slot (row * pad + position);
        # the slab layout itself materializes on DEVICE (_pack_slabs) so the
        # wire carries only the raw vectors in the storage dtype.
        lens_l = np.array([len(self.postings[c][0]) for c in cids], np.int64)
        offs_l = np.zeros(C + 1, np.int64)
        np.cumsum(lens_l, out=offs_l[1:])
        P = int(offs_l[-1])
        lens[:C] = lens_l
        valid[:C] = True
        cent[:C, :d] = np.stack([self.centroids[c] for c in cids]) if cids else cent[:0, :d]
        sd = self.policy.storage_dtype
        if self._flat_cache is not None and self._flat_cache[0] == self._gen:
            all_ids, flat_vecs_all = self._flat_cache[1], self._flat_cache[2]
        else:
            all_ids = np.concatenate([self.postings[c][0] for c in cids]) if cids else np.empty(0, np.int64)
            flat_vecs_all = (
                np.concatenate([self.postings[c][1] for c in cids]) if cids else None
            )
        if P:
            flat_ids_all = _ids_i32(all_ids)
            row_of = np.repeat(np.arange(C, dtype=np.int64), lens_l)
            within = np.arange(P, dtype=np.int64) - np.repeat(offs_l[:C], lens_l)
            slots = (row_of * pad + within).astype(np.int32)
            if self._corpus_cache is not None and self._corpus_cache[0] == self._gen:
                # Zero-upload pack: member vectors gather from the build's
                # device-resident corpus (point id == corpus row); the host
                # sends ~1% of the bytes (int32 rows/slots/ids).
                vecs_dev, ids_dev, scales_dev = _pack_slabs_from_corpus(
                    self._corpus_cache[1],
                    flat_ids_all,
                    flat_ids_all,
                    slots,
                    cent,
                    Cpad=Cpad, pad=pad, d_pad=d_pad, sd=sd,
                )
            else:
                vecs_dev, ids_dev, scales_dev = _pack_slabs(
                    flat_vecs_all,
                    jnp.asarray(flat_ids_all),
                    slots,
                    cent,
                    Cpad=Cpad, pad=pad, d_pad=d_pad, sd=sd,
                )
        else:  # pragma: no cover - guarded by the empty-index check
            vecs_dev = jnp.zeros((Cpad, pad, d_pad), sd)
            ids_dev = jnp.full((Cpad, pad), -1, jnp.int32)
            scales_dev = jnp.ones((Cpad,), jnp.float32)
        for row, c in enumerate(cids):
            cluster_rows[c] = row
        self._padded_view = PaddedView(
            centroids=self._cast_centroids(cent),
            cent_valid=jnp.asarray(valid),
            lens=jnp.asarray(lens),
            ids2d=ids_dev,
            vectors3d=vecs_dev,
            scales=scales_dev,
            pad=pad,
            d_pad=d_pad,
            cluster_rows=cluster_rows,
            max_dup=self._refresh_mult(all_ids),
            free_rows=list(range(Cpad - 1, C - 1, -1)),
            snapshot={c: self.postings[c][0] for c in cids},
        )
        self._padded_gen = self._gen
        self._dirty_padded = set()
        self._dirty_centroid = set()
        self._hbm_guard(int(vecs_dev.size) * vecs_dev.dtype.itemsize)
        return self._padded_view

    def _hbm_guard(self, view_bytes: int, budget: int = 8 << 30) -> None:
        """Drop the device-resident build corpus once a packed view plus the
        corpus would pass ``budget`` bytes of device memory.  The corpus
        cache only accelerates future FULL repacks — postings
        materialize lazily from the host copy, so dropping it costs nothing
        until a bulk rebuild, which re-uploads."""
        if self._corpus_cache is None:
            return
        corpus = self._corpus_cache[1]
        if view_bytes + int(corpus.size) * corpus.dtype.itemsize > budget:
            self._corpus_cache = None

    def _apply_padded_updates(self) -> bool:
        """Scatter the dirty postings into the live padded view.

        Two tiers:
        * **append fast path** — a posting whose previous ids are a prefix of
          its new ids (the streaming-insert shape) uploads only the appended
          member rows: O(new vectors * d_pad) traffic;
        * **slab rewrite** — anything else (deletes, reassigns, new/removed
          postings) re-uploads that posting's (pad, d_pad) slab.

        Returns False when the change cannot land in place (slab overflow, no
        free rows, dim growth) — caller falls back to a full pack."""
        view = self._padded_view
        dirty = self._dirty_padded
        if not dirty:
            return True
        d = self.dim
        if d > view.d_pad:
            return False
        # Plan first (no mutation until the whole batch is known to fit).
        new_rows_needed = [
            c for c in dirty if c in self.postings and c not in view.cluster_rows
        ]
        if len(new_rows_needed) > len(view.free_rows):
            return False
        for c in dirty:
            if c in self.postings and len(self.postings[c][0]) > view.pad:
                return False

        appends: List[Tuple[int, int, np.ndarray, np.ndarray]] = []  # (row, old_len, add_ids, add_vecs)
        append_rows: List[Tuple[int, int]] = []  # (row, new_len)
        row_of: Dict[int, int] = {}  # slab rewrites
        free = list(view.free_rows)
        for c in sorted(dirty):
            if c in self.postings:
                ids, vecs = self.postings[c]
                row = view.cluster_rows.get(c, -1)
                old = view.snapshot.get(c)
                # Prefix-equal ids imply prefix-equal VALUES: a vector id's
                # coordinates are immutable (updates mint fresh ids), so an
                # id-prefix match certifies the resident slab rows verbatim.
                if (
                    row >= 0
                    and old is not None
                    and c not in self._dirty_centroid
                    and len(ids) > len(old)
                    and np.array_equal(ids[: len(old)], old)
                    and self._append_scale_ok(view, row, c, vecs, len(old))
                ):
                    appends.append(
                        (row, len(old), ids[len(old):], vecs[len(old):],
                         self.centroids[c])
                    )
                    append_rows.append((row, len(ids)))
                    view.snapshot[c] = ids
                    continue
                if row < 0:
                    row = free.pop()
                row_of[c] = row
            elif c in view.cluster_rows:
                row_of[c] = view.cluster_rows[c]  # removed: invalidate row
            # else: created+removed between refreshes — nothing to do

        if appends:
            # FIXED chunk shape (one compiled variant, ever): shape-bucketed
            # batches would compile a fresh program per pow2 size.
            CH = 2048
            B = sum(len(a[2]) for a in appends)
            slots = np.zeros(max(CH, _round_up(B, CH)), np.int32)
            vblk = np.zeros((len(slots), view.d_pad), np.float32)
            iblk = np.zeros(len(slots), np.int32)
            pos = 0
            for row, old_len, add_ids, add_vecs, cent_c in appends:
                k = len(add_ids)
                slots[pos : pos + k] = row * view.pad + old_len + np.arange(k)
                if self.policy.quantized:
                    # Residual codes (values past the slab's range saturate;
                    # a rewrite recomputes the scale).
                    vblk[pos : pos + k, :d] = add_vecs - cent_c[None, :]
                else:
                    vblk[pos : pos + k, :d] = add_vecs
                iblk[pos : pos + k] = _ids_i32(add_ids)
                pos += k
            slots[B:] = slots[0]  # chunk padding: idempotent rewrites
            vblk[B:] = vblk[0]
            iblk[B:] = iblk[0]
            Bc = len(append_rows)
            RC = 512
            arows = np.zeros(max(RC, _round_up(Bc, RC)), np.int32)
            alens = np.zeros(len(arows), np.int32)
            arows[:Bc] = [r for r, _ in append_rows]
            alens[:Bc] = [l for _, l in append_rows]
            arows[Bc:] = arows[0]
            alens[Bc:] = alens[0]
            sd = self.policy.storage_dtype
            if self.policy.quantized:
                # Appended vectors quantize with their posting's EXISTING
                # scale (values past the slab's range saturate at +-127; a
                # slab rewrite recomputes the scale).
                sh = self._view_scales_host(view)
                slot_scale = sh[slots // view.pad][:, None]
            else:
                slot_scale = 1.0
            v3, i2 = view.vectors3d, view.ids2d
            for s0 in range(0, len(slots), CH):
                sc = (
                    slot_scale[s0 : s0 + CH]
                    if self.policy.quantized else 1.0
                )
                v3, i2 = _scatter_appends(
                    v3, i2,
                    jnp.asarray(slots[s0 : s0 + CH]),
                    jnp.asarray(_cast_storage_np(vblk[s0 : s0 + CH], sd, sc)),
                    jnp.asarray(iblk[s0 : s0 + CH]),
                )
            ln = view.lens
            for r0 in range(0, len(arows), RC):
                ln = _scatter_lens(
                    ln, jnp.asarray(arows[r0 : r0 + RC]),
                    jnp.asarray(alens[r0 : r0 + RC]),
                )
            view.vectors3d, view.ids2d, view.lens = v3, i2, ln
            metrics.inc("view.append_updates")
            metrics.inc("view.vectors_appended", B)

        if row_of:
            # Pack the rewrite blocks (host) — one slab per dirty posting.
            # Fixed chunk shape (one compiled variant): slab chunks of 16
            # bound both the padding waste (~16 slabs) and compile count.
            RB = 16
            B = len(row_of)
            Bpad = max(RB, _round_up(B, RB))
            rows = np.zeros(Bpad, np.int32)
            vblk = np.zeros((Bpad, view.pad, view.d_pad), np.float32)
            iblk = np.full((Bpad, view.pad), -1, np.int32)
            lblk = np.zeros(Bpad, np.int32)
            cblk = np.zeros((Bpad, view.d_pad), np.float32)
            sclblk = np.ones(Bpad, np.float32)
            vldblk = np.zeros(Bpad, bool)
            quant = self.policy.quantized
            from spfresh_tpu.core.dtypes import quant_scale_for

            for i, (c, row) in enumerate(sorted(row_of.items())):
                rows[i] = row
                if c in self.postings:
                    ids, vecs = self.postings[c]
                    m = len(ids)
                    if quant:
                        vblk[i, :m, :d] = vecs - self.centroids[c][None, :]
                        if m:
                            # Fresh residual codes: recompute the scale.
                            sclblk[i] = quant_scale_for(vblk[i, :m, :d])
                    else:
                        vblk[i, :m, :d] = vecs
                    iblk[i, :m] = _ids_i32(ids)
                    lblk[i] = m
                    cblk[i, :d] = self.centroids[c]
                    vldblk[i] = True
            rows[B:] = rows[0]  # chunk padding: idempotent rewrites
            vblk[B:] = vblk[0]
            iblk[B:] = iblk[0]
            lblk[B:] = lblk[0]
            cblk[B:] = cblk[0]
            sclblk[B:] = sclblk[0]
            vldblk[B:] = vldblk[0]
            sd = self.policy.storage_dtype
            v3, i2, ln = view.vectors3d, view.ids2d, view.lens
            ce, vl, sc_d = view.centroids, view.cent_valid, view.scales
            for s0 in range(0, Bpad, RB):
                sl = slice(s0, s0 + RB)
                cb = (
                    jnp.asarray(cblk[sl], jnp.float32)
                    if quant else jnp.asarray(cblk[sl], sd)
                )
                v3, i2, ln, ce, vl, sc_d = _scatter_rows(
                    v3, i2, ln, ce, vl, sc_d,
                    jnp.asarray(rows[sl]),
                    jnp.asarray(_cast_storage_np(
                        vblk[sl], sd, sclblk[sl][:, None, None]
                    )),
                    jnp.asarray(iblk[sl]), jnp.asarray(lblk[sl]),
                    cb, jnp.asarray(vldblk[sl]),
                    jnp.asarray(sclblk[sl]),
                )
            view.vectors3d, view.ids2d, view.lens = v3, i2, ln
            view.centroids, view.cent_valid, view.scales = ce, vl, sc_d
            if view.scales_host is not None:
                view.scales_host[rows[:B]] = sclblk[:B]
            # Commit the row-table changes only after the device scatter is
            # dispatched (the plan used a copy of free_rows).
            view.free_rows = free
            for c, row in row_of.items():
                if c in self.postings:
                    view.cluster_rows[c] = row
                    view.snapshot[c] = self.postings[c][0]
                else:
                    view.cluster_rows.pop(c, None)
                    view.snapshot.pop(c, None)
                    view.free_rows.append(row)
            metrics.inc("view.rows_scattered", B)

        view.max_dup = max(view.max_dup, self._dedup_bound())
        metrics.inc("view.incremental_updates")
        self._dirty_centroid = set()
        return True

    # -- search ------------------------------------------------------------

    def search_layout(self) -> str:
        """The posting layout ``search`` reads by default, chosen from the
        index's own history.  "csr" (flat postings, gathered per member) is
        the faster layout for a static index, but any change repacks it
        whole; "slab" (one padded block per posting) takes live updates in
        place.  An index serves from CSR until its first live update and
        from slabs after it (PERF.md, PR 1 findings)."""
        return "slab" if self._mutated_gen else "csr"

    def search(
        self,
        queries,
        k: int,
        nprobe: Optional[int] = None,
        prune_factor: Optional[float] = None,
        batch_size: Optional[int] = None,
        engine: Optional[str] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched ANN search.  Returns (ids (Q, k) int64, dists (Q, k) f32);
        id -1 marks an empty slot (fewer than k reachable candidates).

        ``engine``: None (default) reads the layout ``search_layout`` picks;
        "slab" or "csr" forces one, to compare the two.  Both layouts return
        identical results."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[1] != self.dim:
            raise ValueError(f"query dim {queries.shape[1]} != index dim {self.dim}")
        metrics.inc("search.queries", queries.shape[0])
        if engine is None:
            engine = self.search_layout()
            if engine == "slab":
                self._view = None  # the CSR snapshot is no longer served
        if engine not in ("slab", "csr"):
            raise ValueError(f"unknown search engine {engine!r}")
        if nprobe is None:
            nprobe = self.config.search.nprobe or k  # reference: nprobe == k
        if prune_factor is None:
            prune_factor = self.config.search.prune_factor
        prune = prune_factor is not None
        pf = jnp.float32(prune_factor if prune else 0.0)
        bs = batch_size or self.config.search.query_batch_size
        # Optional reduced query wire.  "bfloat16" halves the per-batch upload; kernels upcast on device,
        # so only the query coordinates carry bf16 rounding.  "int8" ships
        # per-query max-abs-scaled codes + one f32 scale per query (~1/4 of
        # f32, ~1/2 of bf16 wire bytes at high d) and dequantizes inside
        # the search jit — results are the exact search evaluated at the
        # dequantized coordinates, the same contract as the bf16 wire.
        _wire = self.config.search.query_wire
        if _wire == "bfloat16":
            import ml_dtypes

            def _stage(a):
                return jnp.asarray(np.asarray(a).astype(ml_dtypes.bfloat16))

            def _stage_q(a):
                return _stage(a), None
        elif _wire == "int8":

            def _stage_q(a):
                a = np.asarray(a, np.float32)
                s = np.abs(a).max(axis=1, keepdims=True) / 127.0
                s = np.maximum(s, 1e-30).astype(np.float32)
                codes = np.clip(np.rint(a / s), -127, 127).astype(np.int8)
                return jnp.asarray(codes), jnp.asarray(s)
        else:

            def _stage_q(a):
                return jnp.asarray(a), None
        out_i, out_d = [], []
        if engine == "slab":
            view = self.padded_view()
            eff_nprobe = max(1, min(int(nprobe), int(view.centroids.shape[0])))
            # Bound the (batch, nprobe, pad) f32 distance block to ~1 GB.
            bs_p = min(bs, max(1, (1 << 30) // (eff_nprobe * view.pad * 4)))
            qpad = np.zeros((queries.shape[0], view.d_pad), np.float32)
            qpad[:, : self.dim] = queries
            for s in range(0, queries.shape[0], bs_p):
                qb, qs = _stage_q(qpad[s : s + bs_p])
                qi, qd = _search_kernel_padded(
                    qb,
                    view.centroids,
                    view.cent_valid,
                    view.lens,
                    view.ids2d,
                    view.vectors3d,
                    view.scales,
                    pf,
                    k=int(k),
                    nprobe=eff_nprobe,
                    pad=view.pad,
                    metric=self.metric,
                    prune=prune,
                    max_dup=view.max_dup,
                    q_scales=qs,
                )
                out_i.append(qi)
                out_d.append(qd)
        else:
            view = self.device_view()
            nprobe = max(1, min(int(nprobe), int(view.centroids.shape[0])))
            # Probe-chunk when the one-shot candidate gather would exceed
            # ~1 GB (full probe at 1M scale would otherwise ask XLA for a
            # >100 GB fusion output).
            d_eff = self.dim or 1
            bs_eff = max(1, min(bs, queries.shape[0]))
            pc = max(1, (1 << 30) // max(1, bs_eff * view.pad * d_eff * 4))
            if pc < nprobe:
                for s in range(0, queries.shape[0], bs):
                    qb, qs = _stage_q(queries[s : s + bs])
                    qi, qd = _search_kernel_probe_chunked(
                        qb,
                        view.centroids,
                        view.cent_valid,
                        view.offsets,
                        view.lens,
                        view.ids,
                        view.vectors,
                        view.scales,
                        pf,
                        k=int(k),
                        nprobe=nprobe,
                        pad=view.pad,
                        metric=self.metric,
                        prune=prune,
                        max_dup=view.max_dup,
                        probe_chunk=pc,
                        q_scales=qs,
                    )
                    out_i.append(qi)
                    out_d.append(qd)
                return (
                    np.concatenate([np.asarray(x) for x in out_i]).astype(np.int64),
                    np.concatenate([np.asarray(x) for x in out_d]),
                )
            for s in range(0, queries.shape[0], bs):
                qb, qs = _stage_q(queries[s : s + bs])
                qi, qd = _search_kernel(
                    qb,
                    view.centroids,
                    view.cent_valid,
                    view.offsets,
                    view.lens,
                    view.ids,
                    view.vectors,
                    view.scales,
                    pf,
                    k=int(k),
                    nprobe=nprobe,
                    pad=view.pad,
                    metric=self.metric,
                    prune=prune,
                    max_dup=view.max_dup,
                    q_scales=qs,
                )
                out_i.append(qi)
                out_d.append(qd)
        # One device->host sync for the whole call, after all batches are in
        # flight (async dispatch overlaps compute with the next upload).
        # Ids widen back to the host-side int64 id space at the boundary.
        return (
            np.concatenate([np.asarray(x) for x in out_i]).astype(np.int64),
            np.concatenate([np.asarray(x) for x in out_d]),
        )

    def find_k_nearest_neighbor_spann(self, query, k: int) -> Optional[List[PointData]]:
        """Single-query parity API (spann_index.rs:148-197): nprobe = k and
        1.2x pruning ON, like the reference; returns None when pruning leaves
        no candidates (quirk 3 preserved *only* here, deliberately)."""
        ids, _ = self.search(
            np.asarray(query, np.float32)[None, :], k, nprobe=k, prune_factor=1.2
        )
        hits = [int(i) for i in ids[0] if i >= 0]
        if not hits:
            return None
        vec_by_id = self._vectors_for(hits)
        return [PointData(i, vec_by_id[i]) for i in hits]

    def _vectors_for(self, point_ids: List[int]) -> Dict[int, np.ndarray]:
        """Resolve result ids to vectors via a gen-cached sorted id -> cid
        map (binary search per id).  The r1 full-postings scan was the wrong
        shape past ~100k clusters and would also materialize every LAZY
        posting's vectors; this touches only the postings that actually hold
        the requested ids."""
        if getattr(self, "_id_map_gen", None) != self._gen:
            cids = sorted(self.postings)
            if cids:
                all_ids = np.concatenate([self.postings[c][0] for c in cids])
                all_cids = np.repeat(
                    np.fromiter(cids, np.int64, len(cids)),
                    [len(self.postings[c][0]) for c in cids],
                )
                order = np.argsort(all_ids, kind="stable")
                self._id_map = (all_ids[order], all_cids[order])
            else:
                self._id_map = (np.empty(0, np.int64), np.empty(0, np.int64))
            self._id_map_gen = self._gen
        sids, scids = self._id_map
        out: Dict[int, np.ndarray] = {}
        for pid in point_ids:
            j = int(np.searchsorted(sids, pid))
            if j < len(sids) and sids[j] == pid:
                ids, vecs = self.postings[int(scids[j])]
                row = int(np.nonzero(ids == pid)[0][0])
                out[int(pid)] = np.asarray(vecs[row : row + 1])[0]
        return out

    # -- persistence -------------------------------------------------------

    def save(self, directory: Optional[str] = None, format: str = "packed") -> str:
        """Persist the index (save_kdtree/save_posting_list parity,
        spann_index.rs:45-53,116-131).  ``packed`` writes one CSR file;
        ``per_cluster`` writes one file per posting list like the reference."""
        directory = directory or self.config.output_path
        os.makedirs(directory, exist_ok=True)
        cids = sorted(self.postings)
        # Centroids: gzip parity with the reference's gzip+bincode kdtree.
        cent = np.stack([self.centroids[c] for c in cids]).astype(np.float32)
        with gzip.open(os.path.join(directory, CENTROIDS_FILE), "wb") as f:
            np.save(f, cent)
        if format == "packed":
            lens = np.array([len(self.postings[c][0]) for c in cids], np.int64)
            offsets = np.zeros(len(cids) + 1, np.int64)
            np.cumsum(lens, out=offsets[1:])
            ids = (
                np.concatenate([self.postings[c][0] for c in cids])
                if cids
                else np.empty(0, np.int64)
            )

            # Stream the vector region posting by posting: a fresh build's
            # member vectors are lazy views over the corpus, and a packed
            # save must not materialize replication x corpus in RAM (a 20M
            # DEEP-shape save needs ~16 GB live + as much again in
            # concatenate/tobytes copies the old path made).
            def _vec_blocks():
                for c in cids:
                    v = self.postings[c][1]
                    yield v.peek() if isinstance(v, _LazyMemberVecs) else np.asarray(
                        v, np.float32
                    )

            write_packed_postings_streaming(
                os.path.join(directory, PACKED_FILE),
                cids,
                offsets,
                ids,
                _vec_blocks(),
                self.dim or 0,
            )
        elif format == "per_cluster":
            store = FileBasedPostingListStore(directory)
            for c in cids:
                pids_, pvecs_ = self.postings[c]
                # Lazy member views stream WITHOUT caching (peek), same as
                # the packed writer: caching here would accumulate
                # replication x corpus in RAM over the loop.
                if isinstance(pvecs_, _LazyMemberVecs):
                    pvecs_ = pvecs_.peek()
                store.insert_posting_list(c, pids_, pvecs_)
        else:
            raise ValueError(f"unknown save format {format!r}")
        manifest = {
            "format_version": 1,
            "layout": format,
            "dim": self.dim,
            "num_clusters": len(cids),
            "cluster_ids": cids,
            "next_cluster_id": self._next_cluster_id,
            "config": self.config.to_dict(),
            # Exact id-multiplicity at save time: spares every later lazy
            # open the O(P log P) unique scan (measured 17 s of a 19 s open
            # at 100M rows).  Live updates keep their own running bound
            # (overlay mult_hint); compaction refreshes this key.
            "max_dup": int(_max_multiplicity(np.concatenate(
                [np.asarray(self.postings[c][0]) for c in cids]
            ) if cids else np.empty(0, np.int64))),
        }
        with open(os.path.join(directory, MANIFEST), "w") as f:
            json.dump(manifest, f)
        return directory

    @classmethod
    def load(cls, directory: str, config: Optional[Config] = None) -> "SpannIndex":
        with open(os.path.join(directory, MANIFEST)) as f:
            manifest = json.load(f)
        cfg = config or Config.from_dict(manifest.get("config", {}))
        idx = cls(cfg)
        idx.dim = manifest["dim"]
        idx._next_cluster_id = manifest.get("next_cluster_id", 0)
        with gzip.open(os.path.join(directory, CENTROIDS_FILE), "rb") as f:
            cent = np.load(f)
        cids = [int(c) for c in manifest["cluster_ids"]]
        for c, v in zip(cids, cent):
            idx.centroids[c] = v
        if manifest["layout"] == "packed":
            pcids, offsets, ids, vecs = read_packed_postings(
                os.path.join(directory, PACKED_FILE)
            )
            for i, c in enumerate(pcids):
                s, e = int(offsets[i]), int(offsets[i + 1])
                idx.postings[int(c)] = (np.array(ids[s:e]), np.array(vecs[s:e]))
        else:
            store = FileBasedPostingListStore.load_from_directory(directory)
            for c in store.cluster_ids():
                got = store.get_posting_list(c)
                if got is not None:
                    idx.postings[c] = got
        idx._next_cluster_id = max(
            [idx._next_cluster_id] + [c + 1 for c in idx.postings]
        )
        idx._gen += 1
        idx._bulk_gen = idx._gen
        return idx
