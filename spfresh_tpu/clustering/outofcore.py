"""Out-of-core index build: the corpus stays host-resident (ndarray or
np.memmap), the device sees only fixed-size row tiles.

The reference builds strictly in memory (spann_builder.rs:25-64 materializes
the full Array2 and clusters it), so its disk-backed design can only SEARCH
corpora larger than RAM, never build them.  This module supplies the missing
capability with an accelerator-first shape — device memory holds one row
tile + the centroid matrix + O(tile) running state, never the corpus:

1. **Sample fit** — learn centroids on a seeded uniform sample with the
   balance cap scaled by the sampling ratio (the standard big-ANN recipe:
   SPANN itself builds billion-scale indexes from clustered samples).  The
   sample build is the existing in-core `HierarchicalClustering`, so every
   invariant (determinism, medoid centroids, multi-way subdivision) carries
   over.
2. **Streaming base assignment** — one pass over the corpus in
   ``tile_rows`` tiles; each tile runs a chunked centroid scan on device
   (fori_loop over centroid chunks, running argmin) so neither the corpus
   nor a (tile, C) matrix for huge C ever materializes.
3. **Host rebalance** — the streamed assignment can overfill a cluster
   beyond the cap (sample noise); oversized clusters are subdivided on the
   host with the SAME farthest-point multi-way algorithm the in-core tail
   levels use (`_split_level_multiway_host`), level-synchronously, with the
   quantile fallback for degenerate (duplicate-heavy) clusters.
4. **Streaming replica pass** — a second pass adds closure replicas under
   the exact in-core admission rule (`_final_replica_pass`:
   d(p, c_j) < bt * d(p, c_base) AND d(c_base, c_j) >= d(p, c_j)) and the
   same per-cluster ``replica_overflow`` budget (closest replicas win).

Transfers route through the xfer accounting (utils/xfer.py), so a build
reports its host<->device copy time beside its wall time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spfresh_tpu.core.dtypes import ACCUM_DTYPE
from spfresh_tpu.clustering.hierarchical import (
    Cluster,
    ClusteringParams,
    HierarchicalClustering,
    _np_rowdist,
    _split_level_multiway_host,
)
from spfresh_tpu.clustering.utils import budget_sort, next_pow2
from spfresh_tpu.ops.distances import EUCLIDEAN, canonical_metric, pairwise_distance
from spfresh_tpu.ops.topk import smallest_k


def _dev_dtype(wire: bool, metric: str):
    """Device dtype for streamed tiles/centroids: bf16 when the corpus rides
    the bf16 wire (the values are exactly bf16-representable, and bf16 x
    bf16 products are exact in the f32 accumulator) — the assign/replica
    kernels then take the bf16 matmul path instead of the f32 HIGHEST
    one.  Euclidean only; see hierarchical.py's
    _finalize_replication for the full argument."""
    if wire and canonical_metric(metric) == EUCLIDEAN:
        return jnp.bfloat16
    return ACCUM_DTYPE

__all__ = ["fit_outofcore", "OutOfCoreResult", "DEFAULT_TILE_ROWS"]

# Device tile default: 64k rows x 128-d f32 = 32 MB per staged tile; the
# adaptive centroid chunk (see _ENTRY_BUDGET) bounds per-dispatch device
# scratch regardless of corpus size, centroid count, or caller tile_rows.
DEFAULT_TILE_ROWS = 65_536
_CENT_CHUNK = 8_192
# Per-dispatch scratch guard: the streamed kernels hold a handful of
# (tile, chunk) f32/s32 temporaries live at once (distances, eligibility,
# running-k concatenations).  The centroid chunk adapts so tile*chunk stays
# under this many entries (~0.5 GB per temp, ~3 GB per dispatch worst case)
# no matter how large a caller's tile_rows is — a 262k-row tile at the
# fixed 8k chunk built 8 GB temps and OOMed a 16 GB chip at 20M x 96.
_ENTRY_BUDGET = 1 << 27
# Host rebalance gathers at most this many member rows per level batch.
_HOST_SPLIT_BATCH_ROWS = 1 << 22


@functools.partial(jax.jit, static_argnames=("metric", "chunk", "n_cents"))
def _oc_base_tile(Xt, cents_p, metric: str, chunk: int, n_cents: int):
    """Running argmin over centroid chunks: returns (base (t,), db (t,)).

    ``cents_p`` is padded to a chunk multiple; columns >= n_cents are inert.
    Ties break to the lowest centroid index (strict < update, ascending
    chunk order)."""
    t, d = Xt.shape
    n_chunks = cents_p.shape[0] // chunk

    def body(i, state):
        best_d, best_i = state
        start = i * chunk
        block = jax.lax.dynamic_slice(cents_p, (start, 0), (chunk, d))
        D = pairwise_distance(Xt, block, metric)  # (t, chunk)
        col = start + jax.lax.broadcasted_iota(jnp.int32, (t, chunk), 1)
        D = jnp.where(col < n_cents, D, jnp.inf)
        cmin = jnp.min(D, axis=1)
        carg = start + jnp.argmin(D, axis=1).astype(jnp.int32)
        upd = cmin < best_d
        return jnp.where(upd, cmin, best_d), jnp.where(upd, carg, best_i)

    init = (jnp.full((t,), jnp.inf), jnp.zeros((t,), jnp.int32))
    best_d, best_i = jax.lax.fori_loop(0, n_chunks, body, init)
    return best_i, best_d


@functools.partial(
    jax.jit,
    static_argnames=("metric", "chunk", "n_cents", "n_extra", "soar_lambda"),
)
def _oc_replica_tile(
    Xt, base, thresh, db, cents_p, metric: str, chunk: int, n_cents: int,
    n_extra: int, soar_lambda: float = 0.0,
):
    """Chunked closure-replica scan with the in-core admission rule
    (hierarchical._final_replica_pass): eligible j satisfies
    D_j < thresh AND d(c_base, c_j) >= D_j AND j != base; returns the
    running ``n_extra`` closest eligible (dists, idx) per row.  ``thresh``
    arrives pre-multiplied by the boundary threshold (bt * d_base); ``db``
    is the raw d_base (used only by the SOAR ranking — see
    hierarchical._final_replica_pass)."""
    t, d = Xt.shape
    n_chunks = cents_p.shape[0] // chunk
    cb = cents_p[base]  # (t, d) base-centroid rows

    def body(i, state):
        best_d, best_i = state
        start = i * chunk
        block = jax.lax.dynamic_slice(cents_p, (start, 0), (chunk, d))
        D = pairwise_distance(Xt, block, metric)  # (t, chunk)
        cc = pairwise_distance(cb, block, metric)  # (t, chunk) base->j
        col = start + jax.lax.broadcasted_iota(jnp.int32, (t, chunk), 1)
        eligible = (
            (D < thresh[:, None])
            & (cc >= D)
            & (col != base[:, None])
            & (col < n_cents)
        )
        if soar_lambda:
            rdot = 0.5 * (db[:, None] + D - cc)
            rank = D + soar_lambda * rdot * rdot / jnp.maximum(
                db[:, None], 1e-30
            )
        else:
            rank = D
        Dm = jnp.where(eligible, rank, jnp.inf)
        cat_d = jnp.concatenate([best_d, Dm], axis=1)
        cat_i = jnp.concatenate([best_i, col], axis=1)
        vals, idx = smallest_k(cat_d, n_extra)
        return vals, jnp.take_along_axis(cat_i, idx, axis=1)

    init = (
        jnp.full((t, n_extra), jnp.inf),
        jnp.zeros((t, n_extra), jnp.int32),
    )
    return jax.lax.fori_loop(0, n_chunks, body, init)


def _pad_cents(cents_np: np.ndarray, chunk: int):
    C = cents_np.shape[0]
    chunk = min(chunk, max(8, next_pow2(C)))
    Cp = ((C + chunk - 1) // chunk) * chunk
    if Cp != C:
        cents_np = np.concatenate(
            [cents_np, np.zeros((Cp - C, cents_np.shape[1]), np.float32)]
        )
    return cents_np, chunk


def _round_wire(arr: np.ndarray, wire: bool) -> np.ndarray:
    if not wire:
        return arr
    import ml_dtypes

    return arr.astype(ml_dtypes.bfloat16).astype(np.float32)


def _stage_tile(data, s: int, e: int, tile_rows: int, wire: bool):
    """One host tile, padded to the uniform shape, in the WIRE dtype: bf16
    tiles ship half the bytes and upcast to f32 on device — the same
    rounded grid `_round_wire` produces on the host."""
    Xt = np.asarray(data[s:e], np.float32)
    if e - s < tile_rows:
        Xt = np.concatenate(
            [Xt, np.zeros((tile_rows - (e - s), Xt.shape[1]), np.float32)]
        )
    if wire:
        import ml_dtypes

        return Xt.astype(ml_dtypes.bfloat16)
    return Xt


@dataclasses.dataclass
class OutOfCoreResult:
    clusters: List[Cluster]
    sample_rows: int
    num_splits: int  # clusters added by the host rebalance


def fit_outofcore(
    params: ClusteringParams,
    data,
    sample_rows: int,
    tile_rows: int = DEFAULT_TILE_ROWS,
    timer=None,
    devices=None,
) -> OutOfCoreResult:
    """Build SPANN clusters for a host-resident corpus.

    ``data``: any 2-d float32 array-like supporting row slicing and fancy
    row indexing — an ndarray, an ``np.memmap`` over a corpus file, etc.
    It is read in bounded slices and never uploaded whole.

    ``devices``: optional list of jax devices — the streamed assign and
    replica passes round-robin their tiles across them (pure data
    parallelism over rows; each device holds its own centroid copy).
    Results are identical for any device count: tiles are independent and
    row-partitioned the same way.  The sample fit and host rebalance are
    small and stay single-device/host.

    Deterministic for a fixed ``params.rng_seed`` (sample draw, sample fit,
    tie-breaks, and host splits all derive from it)."""
    n, d = data.shape
    if sample_rows < params.initial_k:
        raise ValueError(
            f"sample_rows={sample_rows} < initial_k={params.initial_k}"
        )
    cap = params.desired_cluster_size
    if cap is None:
        cap = max(1, int(round(0.18 * n)))
    seed = params.rng_seed if params.rng_seed is not None else 0

    def _p(name):
        return (
            timer.phase(name, block=True)
            if timer is not None
            else contextlib.nullcontext()
        )

    wire = params.wire_dtype not in (None, "float32")
    from spfresh_tpu.utils.xfer import timed_pull, timed_put

    # -- 1. sample fit -----------------------------------------------------
    with _p("oc/sample"):
        rng = np.random.Generator(
            np.random.Philox(key=np.uint64((seed ^ 0x0C0FFEE) & (2**64 - 1)))
        )
        if sample_rows >= n:
            sidx = np.arange(n, dtype=np.int64)
        else:
            sidx = np.sort(rng.choice(n, size=sample_rows, replace=False))
        sample = np.ascontiguousarray(np.asarray(data[sidx], np.float32))
    with _p("oc/sample_fit"):
        sp = dataclasses.replace(
            params,
            desired_cluster_size=max(1, int(round(cap * len(sidx) / n))),
        )
        hc = HierarchicalClustering(sp, sample).fit()
        # hc._host_data carries the wire-rounded grid when wire_dtype is
        # set — centroids must come from the same grid the tiles use.
        sample_rounded = hc._host_data if hc._host_data is not None else sample
        cent_sample_rows = np.asarray(
            [c.centroid_idx for c in hc.clusters], np.int64
        )
        cents_np = np.ascontiguousarray(
            sample_rounded[cent_sample_rows], np.float32
        )
        cent_rows = sidx[cent_sample_rows]  # global corpus rows
        del hc  # frees the sample's device copy

    # -- 2. streaming base assignment -------------------------------------
    with _p("oc/assign"):
        base, db = _stream_base(
            data, cents_np, params.metric, tile_rows, wire, timed_put,
            timed_pull, devices=devices,
        )

    # -- 3. host rebalance of overfilled clusters --------------------------
    with _p("oc/split"):
        cent_rows, cents_np, base, db, num_splits = _host_rebalance(
            data, cent_rows, cents_np, base, db, cap, params, wire, seed
        )

    C = len(cent_rows)
    # -- 4. streaming replica pass -----------------------------------------
    n_extra = min(params.max_replicas - 1, C - 1)
    if n_extra > 0:
        with _p("oc/replica"):
            extras = _stream_replicas(
                data, cents_np, base, db, params, n_extra, tile_rows, wire,
                timed_put, timed_pull, devices=devices,
            )
    else:
        extras = (
            np.empty(0, np.int64),
            np.empty(0, np.int64),
            np.empty(0, np.float32),
        )

    # -- 5. budget + cluster assembly --------------------------------------
    with _p("oc/finalize"):
        clusters = _assemble(
            n, C, cent_rows, base, extras, cap, params.replica_overflow
        )
    return OutOfCoreResult(
        clusters=clusters, sample_rows=len(sidx), num_splits=num_splits
    )


def _stream_base(
    data, cents_np, metric, tile_rows, wire, timed_put, timed_pull,
    devices=None,
):
    n = data.shape[0]
    chunk_cap = max(512, _ENTRY_BUDGET // max(tile_rows, 1))
    cents_p, chunk = _pad_cents(cents_np, min(_CENT_CHUNK, chunk_cap))
    C = cents_np.shape[0]
    devs = list(devices) if devices else [None]
    # One centroid copy per device: tiles round-robin across the mesh (the
    # passes are embarrassingly parallel over rows, so multi-chip
    # out-of-core is plain data parallelism — no collectives).
    dd = _dev_dtype(wire, metric)
    cents_devs = [
        timed_put(cents_p, dv).astype(dd) for dv in devs
    ]
    base = np.empty(n, np.int32)
    db = np.empty(n, np.float32)
    pending = []
    window = max(4, 2 * len(devs))

    def _drain(item):
        s0, e0, b0, d0 = item
        base[s0:e0] = timed_pull(b0)[: e0 - s0]
        db[s0:e0] = timed_pull(d0)[: e0 - s0]

    # Uniform tile shapes: pad the ragged last tile so every dispatch hits
    # the same compiled program; dispatches run ahead of pulls (window
    # scales with device count so every chip stays busy).
    for ti, s in enumerate(range(0, n, tile_rows)):
        e = min(s + tile_rows, n)
        Xt = _stage_tile(data, s, e, tile_rows, wire)
        dv = devs[ti % len(devs)]
        cents_dev = cents_devs[ti % len(devs)]
        b_i, d_i = _oc_base_tile(
            timed_put(Xt, dv).astype(dd), cents_dev, metric, chunk, C,
        )
        pending.append((s, e, b_i, d_i))
        if len(pending) >= window:
            _drain(pending.pop(0))
    for item in pending:
        _drain(item)
    return base, db


def _host_rebalance(data, cent_rows, cents_np, base, db, cap, params, wire, seed):
    """Drop empty clusters, then split any cluster the streamed assignment
    filled past the cap — level-synchronous host farthest-point splits, the
    same algorithm as the in-core tail levels (with the quantile fallback
    for degenerate duplicate-heavy clusters).  Updates base/db in place for
    the affected rows and returns the grown centroid set."""
    cent_rows = np.asarray(cent_rows, np.int64).copy()
    cents_np = np.asarray(cents_np, np.float32).copy()
    C = len(cent_rows)
    counts = np.bincount(base, minlength=C)
    keep = np.flatnonzero(counts > 0)
    if len(keep) < C:
        relabel = np.full(C, -1, np.int64)
        relabel[keep] = np.arange(len(keep))
        base = relabel[base].astype(np.int32)
        cent_rows, cents_np, counts = cent_rows[keep], cents_np[keep], counts[keep]
        C = len(keep)

    num_splits = 0
    max_ways = params.max_split_ways
    rng = np.random.Generator(
        np.random.Philox(key=np.uint64((seed ^ 0x5EED5EED) & (2**64 - 1)))
    )
    while True:
        oversized = np.flatnonzero(counts > cap)
        if len(oversized) == 0:
            break
        order = np.argsort(base, kind="stable")
        bounds = np.searchsorted(base[order], np.arange(C + 1))
        rows_sorted = np.arange(len(base), dtype=np.int64)[order]
        # Batch oversized clusters so one level's host gather stays bounded.
        batches: List[List[int]] = []
        cur: List[int] = []
        cur_rows = 0
        for ci in oversized:
            sz = int(counts[ci])
            if cur and cur_rows + sz > _HOST_SPLIT_BATCH_ROWS:
                batches.append(cur)
                cur, cur_rows = [], 0
            cur.append(int(ci))
            cur_rows += sz
        batches.append(cur)
        new_rows: List[int] = []
        new_vecs: List[np.ndarray] = []
        for group in batches:
            members = [
                np.sort(rows_sorted[bounds[ci] : bounds[ci + 1]])
                for ci in group
            ]
            lens = np.array([len(m) for m in members])
            m_c = np.clip(
                np.ceil(lens / cap).astype(np.int64),
                2,
                min(max_ways, int(lens.max())),
            )
            m_c = np.minimum(m_c, lens)
            M = int(next_pow2(int(m_c.max())))
            flat = np.concatenate(members)  # global corpus rows
            cluster_of = np.repeat(np.arange(len(group)), lens)
            Xg = _round_wire(np.asarray(data[flat], np.float32), wire)
            cum = np.zeros(len(group) + 1, np.int64)
            np.cumsum(lens, out=cum[1:])
            offs = rng.integers(0, np.maximum(lens, 1))
            c1_local = (cum[:-1] + offs).astype(np.int64)
            # point_list = LOCAL positions into Xg; returned seeds are local.
            local_pos = np.arange(len(flat), dtype=np.int64)
            assign, seeds_local, cnts, d1 = _split_level_multiway_host(
                Xg, local_pos, cluster_of.astype(np.int64), c1_local, m_c,
                params.metric, nm=len(group), m_ways=M,
            )
            degenerate = cnts.max(axis=1) == lens
            for r, ci in enumerate(group):
                lo, hi = int(cum[r]), int(cum[r + 1])
                if degenerate[r]:
                    # Balanced quantile split on d1 (guaranteed progress).
                    order_r = np.argsort(d1[lo:hi], kind="stable")
                    local_parts = [
                        p
                        for p in np.array_split(order_r, int(m_c[r]))
                        if len(p)
                    ]
                    seed_locals = [int(lo + p[0]) for p in local_parts]
                    part_rows = [flat[lo + p] for p in local_parts]
                    d_parts = [
                        _np_rowdist(
                            Xg[lo + p], Xg[sl][None, :].repeat(len(p), 0),
                            params.metric,
                        )
                        for p, sl in zip(local_parts, seed_locals)
                    ]
                else:
                    a = assign[lo:hi]
                    uniq = np.unique(a)
                    seed_locals = [int(seeds_local[r, j]) for j in uniq]
                    local_parts = [np.flatnonzero(a == j) for j in uniq]
                    part_rows = [flat[lo + p] for p in local_parts]
                    d_parts = [
                        _np_rowdist(
                            Xg[lo + p], Xg[sl][None, :].repeat(len(p), 0),
                            params.metric,
                        )
                        for p, sl in zip(local_parts, seed_locals)
                    ]
                # First child keeps label ci; others get fresh labels.
                cent_rows[ci] = int(flat[seed_locals[0]])
                cents_np[ci] = Xg[seed_locals[0]]
                base[part_rows[0]] = ci
                db[part_rows[0]] = d_parts[0]
                for j in range(1, len(local_parts)):
                    nc = C + len(new_rows)
                    base[part_rows[j]] = nc
                    db[part_rows[j]] = d_parts[j]
                    new_rows.append(int(flat[seed_locals[j]]))
                    new_vecs.append(Xg[seed_locals[j]])
                    num_splits += 1
        if new_rows:
            cent_rows = np.concatenate(
                [cent_rows, np.asarray(new_rows, np.int64)]
            )
            cents_np = np.concatenate(
                [cents_np, np.stack(new_vecs).astype(np.float32)]
            )
        C = len(cent_rows)
        counts = np.bincount(base, minlength=C)
    return cent_rows, cents_np, base, db, num_splits


def _stream_replicas(
    data, cents_np, base, db, params, n_extra, tile_rows, wire, timed_put,
    timed_pull, devices=None,
):
    n = data.shape[0]
    chunk_cap = max(512, _ENTRY_BUDGET // max(tile_rows, 1))
    cents_p, chunk = _pad_cents(cents_np, min(_CENT_CHUNK, chunk_cap))
    C = cents_np.shape[0]
    devs = list(devices) if devices else [None]
    cents_devs = [
        timed_put(cents_p, dv).astype(_dev_dtype(wire, params.metric))
        for dv in devs
    ]
    dd = _dev_dtype(wire, params.metric)
    bt = np.float32(params.boundary_threshold)
    pts_l: List[np.ndarray] = []
    cls_l: List[np.ndarray] = []
    d_l: List[np.ndarray] = []
    pending = []

    def _drain(item):
        s0, e0, i0, d0 = item
        idx = np.asarray(timed_pull(i0))[: e0 - s0]
        dists = np.asarray(timed_pull(d0))[: e0 - s0]
        valid = np.isfinite(dists)
        rows = np.broadcast_to(np.arange(s0, e0)[:, None], idx.shape)
        pts_l.append(rows[valid].astype(np.int64))
        cls_l.append(idx[valid].astype(np.int64))
        d_l.append(dists[valid])

    soar = float(params.soar_lambda or 0.0)
    window = max(4, 2 * len(devs))
    for ti, s in enumerate(range(0, n, tile_rows)):
        e = min(s + tile_rows, n)
        Xt = _stage_tile(data, s, e, tile_rows, wire)
        dv = devs[ti % len(devs)]
        cents_dev = cents_devs[ti % len(devs)]
        base_t = base[s:e].astype(np.int32)
        thresh_t = (db[s:e] * bt).astype(np.float32)
        db_t = db[s:e].astype(np.float32)
        if e - s < tile_rows:
            padr = tile_rows - (e - s)
            base_t = np.concatenate([base_t, np.zeros(padr, np.int32)])
            # -inf threshold: padding rows admit nothing.
            thresh_t = np.concatenate(
                [thresh_t, np.full(padr, -np.inf, np.float32)]
            )
            db_t = np.concatenate([db_t, np.zeros(padr, np.float32)])
        d0, i0 = _oc_replica_tile(
            timed_put(Xt, dv).astype(dd),
            timed_put(base_t, dv),
            timed_put(thresh_t, dv),
            timed_put(db_t, dv),
            cents_dev,
            params.metric,
            chunk,
            C,
            n_extra,
            soar_lambda=soar,
        )
        pending.append((s, e, i0, d0))
        if len(pending) >= window:
            _drain(pending.pop(0))
    for item in pending:
        _drain(item)
    return (
        np.concatenate(pts_l) if pts_l else np.empty(0, np.int64),
        np.concatenate(cls_l) if cls_l else np.empty(0, np.int64),
        np.concatenate(d_l) if d_l else np.empty(0, np.float32),
    )


def _assemble(n, C, cent_rows, base, extras, cap, replica_overflow):
    """Base groups + budgeted closest replicas -> Cluster list (the in-core
    _finalize_replication budget rule: members <= ceil(overflow * cap),
    closest replicas win the remaining slots)."""
    order = np.argsort(base, kind="stable")
    bounds = np.searchsorted(base[order], np.arange(C + 1))
    pts_all = np.arange(n, dtype=np.int64)[order]
    e_pts, e_cls, e_d = extras
    limit = max(int(np.ceil(replica_overflow * cap)), 1)
    if len(e_pts):
        eorder = budget_sort(e_cls, e_d)
        e_pts, e_cls = e_pts[eorder], e_cls[eorder]
        ebounds = np.searchsorted(e_cls, np.arange(C + 1))
    clusters: List[Cluster] = []
    for ci in range(C):
        pts = np.sort(pts_all[bounds[ci] : bounds[ci + 1]])
        if len(e_pts):
            budget = max(0, limit - len(pts))
            lo, hi = int(ebounds[ci]), int(ebounds[ci + 1])
            extra = e_pts[lo : lo + min(budget, hi - lo)]
            if len(extra):
                pts = np.sort(np.concatenate([pts, extra]))
        clusters.append(Cluster(int(cent_rows[ci]), pts, 0))
    return clusters
