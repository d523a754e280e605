"""Hierarchical balanced clustering on the accelerator.

Re-design of the reference's clustering engine
(/root/reference/src/clustering/hierarchical.rs) with the same capability
surface — Random / KMeans++ init, single assign + medoid ("real data vector
as centroid", hierarchical.rs:27) update round, SPANN boundary-closure
replication (BOUNDARY_THRESHOLD = 1.1, hierarchical.rs:55,328-346), and
size-capped subdivision — but batched into matrix operations instead of
per-point rayon loops:

* assignment = one (n, k) pairwise-distance matrix + argmin + a vectorized
  closure mask (hierarchical.rs:295-364 becomes ~10 array ops);
* medoid update = segment-mean via mask^T @ X matmul + masked argmin
  (hierarchical.rs:138-181);
* KMeans++ = running min-distance recurrence inside one `lax.fori_loop`,
  O(k n d) total instead of the reference's O(k^2 n d) rescan
  (hierarchical.rs:249-293);
* subdivision = **level-synchronous**: every oversized cluster at a level is
  split in a single batched device call over a (S, L)-padded member matrix
  (hierarchical.rs:74-135 does them one at a time). Shapes are padded to
  powers of two so at most O(log^2 n) kernel variants compile.

Deliberate deviations from the reference (SURVEY.md section 5 quirks):
* quirk 6 — a split that makes no progress (duplicate-heavy clusters) falls
  back to an exact balanced median split instead of looping forever;
* cluster ordering after subdivision differs (level order vs. the reference's
  replace-in-place + push), which only affects `labels()` tie-breaking.

Determinism: a single integer seed drives `jax.random` keys; per-split keys
are derived with `fold_in` so results are reproducible for a given seed
(parity in spirit with rng_seed/SmallRng, hierarchical.rs:184-189).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spfresh_tpu.clustering.utils import budget_sort, masked_means, next_pow2
from spfresh_tpu.utils import metrics

log = logging.getLogger(__name__)
from spfresh_tpu.core.dtypes import ACCUM_DTYPE
from spfresh_tpu.core.platform import routes
from spfresh_tpu.ops.distances import (
    EUCLIDEAN,
    canonical_metric,
    pairwise_distance,
    rowwise_distance,
)

RANDOM = "Random"
KMEANS_PLUS_PLUS = "KMeans++"
INIT_METHODS = (RANDOM, KMEANS_PLUS_PLUS)

# SPANN boundary closure factor (hierarchical.rs:55).
BOUNDARY_THRESHOLD = 1.1


def canonical_init(name: str) -> str:
    lowered = str(name).strip().lower()
    for m in INIT_METHODS:
        if lowered == m.lower() or lowered == m.replace("++", "plusplus").lower():
            return m
    raise ValueError(f"unknown initialization method {name!r}; expected one of {list(INIT_METHODS)}")


@dataclasses.dataclass
class ClusteringParams:
    """Mirror of ClusteringParams (hierarchical.rs:18-24), plus replication
    control.

    ``replication``:
    * ``"final"`` (default) — subdivision uses hard balanced splits and ONE
      global closure pass at the end adds each point to at most
      ``max_replicas - 1`` extra clusters within the boundary threshold of
      its base cluster.  This is the SPANN paper's multi-replica assignment
      with a replica cap.
    * ``"nested"`` — reference parity: closure replication inside every
      assignment/split (hierarchical.rs:328-346).  WARNING: replicas compound
      multiplicatively with subdivision depth — with a small cluster-size cap
      on clustered data this explodes (measured 44x blowup on a 64-mixture
      set at cap=256); it matches the reference only at the reference's
      shallow default (cap = 0.18 n -> 2-3 levels).
    """

    metric: str = EUCLIDEAN
    initialization_method: str = RANDOM
    desired_cluster_size: Optional[int] = None
    initial_k: int = 4
    rng_seed: Optional[int] = None
    boundary_threshold: float = BOUNDARY_THRESHOLD
    replication: str = "final"
    # 4 mirrors Config's default (see its comment).
    max_replicas: int = 4
    # Posting-length ceiling under 'final' replication: a cluster accepts
    # replicas only up to ceil(replica_overflow * cap) total members (closest
    # replicas win).  Keeps the padded search layout tight — without it,
    # popular clusters absorb replicas from every neighbor and one fat
    # posting inflates the pad for the whole index.
    replica_overflow: float = 1.25
    # Children per subdivision round ('final' replication only; 'nested'
    # keeps the reference's binary splits).  8-way levels replace three
    # binary levels: fewer device rounds and fewer padded shape buckets.
    max_split_ways: int = 8
    # Host->device dtype for the build corpus.  "bfloat16" halves the
    # dominant one-time upload (512 MB at 1M x 128 over a slow link); the
    # corpus is upcast to f32 on device, so all clustering math still
    # accumulates in f32 over bf16-rounded coordinates — the same rounding
    # class the bf16 STORAGE index serves from anyway.  None = float32.
    wire_dtype: Optional[str] = None
    # SOAR replica ranking (spilled, orthogonality-amplified residuals —
    # the ScaNN-style secondary-assignment rule): admitted closure
    # candidates are ranked by D + lambda (r_j.r_1)^2/|r_1|^2 instead of
    # plain distance, preferring replicas whose quantization residual is
    # orthogonal to the primary's — better recall per stored replica when
    # routing misses the base cluster.  None/0 = reference closure ranking.
    # Euclidean only (residual dots are an inner-product construction).
    soar_lambda: Optional[float] = None

    def __post_init__(self):
        self.metric = canonical_metric(self.metric)
        self.initialization_method = canonical_init(self.initialization_method)
        if self.initial_k <= 0:
            raise ValueError("initial_k must be > 0")
        if self.replication not in ("final", "nested"):
            raise ValueError("replication must be 'final' or 'nested'")
        if self.max_replicas < 1:
            raise ValueError("max_replicas must be >= 1")
        if self.max_split_ways < 2:
            raise ValueError("max_split_ways must be >= 2")
        if self.max_split_ways > 128:
            # The split kernels return child indices as int8 (quarters the
            # per-level pull); 128-way levels already collapse any realistic
            # depth, so the wire dtype bounds the knob rather than a
            # silently-overflowing assignment.
            raise ValueError("max_split_ways must be <= 128")
        if self.soar_lambda is not None:
            if self.soar_lambda < 0:
                raise ValueError("soar_lambda must be >= 0")
            if self.soar_lambda and self.metric != "Euclidean":
                raise ValueError("soar_lambda requires the Euclidean metric")


@dataclasses.dataclass
class Cluster:
    """Mirror of Cluster (hierarchical.rs:26-30): medoid index + member ids."""

    centroid_idx: int
    points: np.ndarray  # int64 indices into the dataset
    depth: int = 0

    def __len__(self) -> int:
        return int(self.points.shape[0])


# ---------------------------------------------------------------------------
# Jitted building blocks
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("metric",))
def _assign_with_closure(X, cent_vecs, metric: str, boundary_threshold):
    """Vectorized form of assign_points_to_clusters (hierarchical.rs:295-364).

    Returns a bool (n, k) membership mask: the nearest centroid plus every
    centroid j with dist(p, c_j) < bt * min_dist AND
    dist(c_best, c_j) >= dist(p, c_j).
    """
    D = pairwise_distance(X, cent_vecs, metric)  # (n, k)
    best = jnp.argmin(D, axis=1)
    min_d = jnp.min(D, axis=1)
    cc = pairwise_distance(cent_vecs, cent_vecs, metric)  # (k, k)
    thr = boundary_threshold.astype(ACCUM_DTYPE) * min_d
    onehot = jax.nn.one_hot(best, D.shape[1], dtype=bool)
    replica = (D < thr[:, None]) & (cc[best] >= D)
    return onehot | replica


@functools.partial(jax.jit, static_argnames=("metric",))
def _medoid_update(X, member_mask, old_idx, metric: str):
    """update_centroids (hierarchical.rs:138-181): per-cluster mean, then the
    member point closest to that mean.  Empty clusters keep their centroid."""
    means = masked_means(X, member_mask)  # (k, d)
    Dm = pairwise_distance(X, means, metric)  # (n, k)
    Dm = jnp.where(member_mask, Dm, jnp.inf)
    new_idx = jnp.argmin(Dm, axis=0)
    counts = jnp.sum(member_mask, axis=0)
    return jnp.where(counts > 0, new_idx, old_idx)


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _assign_medoid_fused(X, cents, old_idx, k: int, metric: str):
    """Hard assignment + medoid update in ONE device program: the unfused
    route pulled the (n,) argmin, rebuilt an (n, k) bool mask on the host,
    and uploaded it back (16 MB each way at the 1M bench shape) only for `_medoid_update` to reduce it again.  The mask here is
    the same `best == j` predicate computed on device, so results are
    bit-identical to `_assign_points` + `_update_centroids` (tested)."""
    D = pairwise_distance(X, cents, metric)              # (n, k)
    best = jnp.argmin(D, axis=1)                         # (n,)
    mask = best[:, None] == jnp.arange(k, dtype=best.dtype)[None, :]
    return best, _medoid_update(X, mask, old_idx, metric)


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _kmeanspp_init(key, X, k: int, metric: str):
    """KMeans++ seeding (hierarchical.rs:249-293) as a running min-distance
    recurrence: one O(n d) pass per seed, d^2-weighted categorical sampling."""
    n = X.shape[0]
    first = jax.random.randint(jax.random.fold_in(key, 0), (), 0, n)
    min_d = rowwise_distance(X, X[first][None, :], metric)
    chosen = jnp.zeros((k,), jnp.int32).at[0].set(first.astype(jnp.int32))

    def body(i, state):
        min_d, chosen = state
        w = min_d * min_d
        total = jnp.sum(w)
        # All-zero weights (every point already a centroid / duplicates):
        # fall back to uniform, as the reference does on sampling failure
        # (hierarchical.rs:286-291).
        w = jnp.where(total > 0, w, jnp.ones_like(w))
        idx = jax.random.categorical(jax.random.fold_in(key, i), jnp.log(w))
        d_new = rowwise_distance(X, X[idx][None, :], metric)
        min_d = jnp.minimum(min_d, d_new)
        return min_d, chosen.at[i].set(idx.astype(jnp.int32))

    _, chosen = jax.lax.fori_loop(1, k, body, (min_d, chosen))
    return chosen


@functools.partial(
    jax.jit, static_argnames=("metric", "n_extra", "soar_lambda")
)
def _final_replica_pass(X_tile, base_tile, cents, metric: str, boundary_threshold, n_extra: int,
                        soar_lambda: float = 0.0):
    """Global closure pass (``replication='final'``): for each point, the
    n_extra nearest non-base clusters j with
    dist(p, c_j) < bt * dist(p, c_base) AND dist(c_base, c_j) >= dist(p, c_j)
    (the reference's closure rule, hierarchical.rs:328-346, applied once
    against the full centroid set).  The centroid-centroid rows are computed
    per tile — a full (C, C) matrix is 16 GB at 5M-scale cluster counts.
    ``soar_lambda`` > 0 ranks admitted candidates by the SOAR score
    D + lambda (r_j.r_1)^2/|r_1|^2 instead of plain distance (Euclidean
    only; the residual dot comes by polarization, 2 r_j.r_1 = db + D - cc).
    Returns (idx (t, n_extra), distances — SOAR scores when ranked so)."""
    D = pairwise_distance(X_tile, cents, metric)  # (t, C)
    db = jnp.take_along_axis(D, base_tile[:, None], axis=1)[:, 0]
    bt = boundary_threshold.astype(ACCUM_DTYPE)
    onehot = jax.nn.one_hot(base_tile, D.shape[1], dtype=bool)
    cc_base = pairwise_distance(cents[base_tile], cents, metric)  # (t, C)
    eligible = (D < (bt * db)[:, None]) & (cc_base >= D) & ~onehot
    if soar_lambda:
        rdot = 0.5 * (db[:, None] + D - cc_base)
        rank = D + soar_lambda * rdot * rdot / jnp.maximum(db[:, None], 1e-30)
    else:
        rank = D
    Dm = jnp.where(eligible, rank, jnp.inf)
    vals, idx = jax.lax.top_k(-Dm, n_extra)
    return idx, -vals


@functools.partial(jax.jit, static_argnames=("n_extra", "soar_lambda"))
def _replica_select_from_dists(
    D, cc_base, base_tile, boundary_threshold, n_extra: int,
    soar_lambda: float = 0.0,
):
    """Selection stage of the closure pass given precomputed distance
    blocks — the L1/Linf UNFUSED route.  The fused form (two elementwise
    pairwise passes + top_k in one program, as the Euclidean route runs)
    compiled for minutes at GIST shapes (12k x 10.7k x 960) on an earlier
    accelerator, while each component compiled in seconds; the fused shape
    also depends on the data-dependent C, so every build would pay that
    compile afresh.  Three small dispatches per row group avoid both."""
    db = jnp.take_along_axis(D, base_tile[:, None], axis=1)[:, 0]
    bt = boundary_threshold.astype(ACCUM_DTYPE)
    onehot = jax.nn.one_hot(base_tile, D.shape[1], dtype=bool)
    eligible = (D < (bt * db)[:, None]) & (cc_base >= D) & ~onehot
    if soar_lambda:
        rdot = 0.5 * (db[:, None] + D - cc_base)
        rank = D + soar_lambda * rdot * rdot / jnp.maximum(
            db[:, None], 1e-30
        )
    else:
        rank = D
    Dm = jnp.where(eligible, rank, jnp.inf)
    vals, idx = jax.lax.top_k(-Dm, n_extra)
    return idx, -vals


@functools.partial(jax.jit, static_argnames=("metric", "num_segments", "m_ways"))
def _split_level_multiway(
    X, point_list, cluster_of, p_count, c1_idx, seed_valid, metric: str,
    num_segments: int, m_ways: int,
):
    """Batched M-WAY split of every oversized cluster at a level.

    Generalizes the binary split (create_subclusters,
    hierarchical.rs:107-135) to ``m_ways`` children per cluster in ONE level:
    a cluster of size L needs ~ceil(L/cap) children, so a level of 8-way
    splits replaces three binary levels — fewer device rounds, fewer padded
    shape buckets to compile, same O(P d) memory.

    Seeds are farthest-point: seed_0 = c1_idx (a random member), seed_j =
    member farthest from all previous seeds.  Assignment folds into seed
    selection: the running min-distance/argmin over seeds IS the final
    nearest-seed assignment (ties to the earliest seed, matching the
    reference's fold semantics).

    seed_valid (S, m_ways) masks how many children each cluster actually
    wants (clusters near the cap need only 2).  ``p_count`` is the number
    of real (non-padding) rows at the front of the member tables — a
    device scalar, replacing the 1 MB/level bool-table upload.  Returns
    (assign (P,) int8 child index, seeds (S, m_ways) int32 dataset rows,
    counts (S, m_ways) member counts, d1 (P,) distances to seed 0 for the
    host-side balanced fallback)."""
    return _split_level_core(
        X, point_list, cluster_of, p_count, c1_idx, seed_valid, metric,
        num_segments, m_ways,
    )


def _split_level_core(
    X, point_list, cluster_of, p_count, c1_idx, seed_valid, metric: str,
    num_segments: int, m_ways: int,
):
    """Shared body of the level-split kernels (`_split_level_multiway` and
    the device-resident `_split_level_resident`): op-for-op identical math
    so both callers produce bit-identical assignments for the same member
    tables."""
    P = point_list.shape[0]
    S = num_segments
    cluster_of = cluster_of.astype(jnp.int32)  # int16 on the wire when S<=32k
    pts = X[point_list]  # (P, d)
    pos = jnp.arange(P, dtype=jnp.int32)
    valid = pos < p_count

    seeds = jnp.zeros((S, m_ways), jnp.int32)
    seeds = seeds.at[:, 0].set(c1_idx.astype(jnp.int32))
    d_min = rowwise_distance(pts, X[c1_idx][cluster_of], metric)  # (P,)
    d1 = d_min
    best_j = jnp.zeros(P, jnp.int32)
    taken = point_list == c1_idx[cluster_of]

    for j in range(1, m_ways):
        ok = seed_valid[:, j]  # (S,) does this cluster want a j-th child?
        # Farthest member from the chosen seeds becomes seed j.
        d_masked = jnp.where(valid & ~taken & ok[cluster_of], d_min, -jnp.inf)
        seg_max = jax.ops.segment_max(d_masked, cluster_of, num_segments=S)
        at_max = (d_masked == seg_max[cluster_of]) & valid & ~taken & ok[cluster_of]
        sj_pos = jax.ops.segment_min(
            jnp.where(at_max, pos, P), cluster_of, num_segments=S
        )
        found = sj_pos < P
        sj_pos = jnp.clip(sj_pos, 0, P - 1)
        seed_j = point_list[sj_pos]
        seeds = seeds.at[:, j].set(jnp.where(found, seed_j, seeds[:, 0]))
        use = ok & found
        d_new = rowwise_distance(pts, X[seed_j][cluster_of], metric)
        upd = use[cluster_of] & (d_new < d_min)
        best_j = jnp.where(upd, j, best_j)
        d_min = jnp.where(upd, d_new, d_min)
        taken = taken | ((pos == sj_pos[cluster_of]) & use[cluster_of])

    ones = valid.astype(jnp.int32)
    counts = jax.ops.segment_sum(
        ones, cluster_of * m_ways + best_j, num_segments=S * m_ways
    ).reshape(S, m_ways)
    # int8 assign quarters the per-level pull (m_ways <= 127 structurally).
    return best_j.astype(jnp.int8), seeds, counts, d1


def _np_rowdist(a: np.ndarray, b: np.ndarray, metric: str) -> np.ndarray:
    diff = a - b
    if metric == "Manhattan":
        return np.abs(diff).sum(axis=1)
    if metric == "Chebyshev":
        return np.abs(diff).max(axis=1)
    return (diff * diff).sum(axis=1)


def _split_level_multiway_host(
    X: np.ndarray, point_list, cluster_of, c1_idx, m_c, metric: str,
    nm: int, m_ways: int,
):
    """Numpy mirror of ``_split_level_multiway`` for small TAIL levels.

    The subdivision loop runs until no cluster exceeds the cap; unbalanced
    farthest-point splits leave a long tail of levels that each split a few
    straggler clusters — 28 levels measured on a 1M build, each paying
    ~1.4 s of device dispatch + transfer for <0.1 s of math.  Below a size
    threshold the same algorithm (same seeds, same tie-breaks) runs on the
    host in microseconds-per-level; both the single-device and the mesh
    build take this path identically, preserving their bit-equality."""
    P = point_list.shape[0]
    pts = X[point_list]  # (P, d) f32
    pos = np.arange(P)
    seeds = np.zeros((nm, m_ways), np.int32)
    seeds[:, 0] = c1_idx
    d_min = _np_rowdist(pts, X[c1_idx][cluster_of], metric)
    d1 = d_min.copy()
    best_j = np.zeros(P, np.int32)
    taken = point_list == c1_idx[cluster_of]
    for j in range(1, m_ways):
        ok = j < m_c  # (nm,)
        d_masked = np.where(~taken & ok[cluster_of], d_min, -np.inf)
        seg_max = np.full(nm, -np.inf, d_masked.dtype)
        np.maximum.at(seg_max, cluster_of, d_masked)
        at_max = (d_masked == seg_max[cluster_of]) & ~taken & ok[cluster_of]
        sj_pos = np.full(nm, P, np.int64)
        np.minimum.at(sj_pos, cluster_of[at_max], pos[at_max])
        found = sj_pos < P
        sj_pos_c = np.clip(sj_pos, 0, P - 1)
        seed_j = point_list[sj_pos_c].astype(np.int32)
        seeds[:, j] = np.where(found, seed_j, seeds[:, 0])
        use = ok & found
        d_new = _np_rowdist(pts, X[seed_j][cluster_of], metric)
        upd = use[cluster_of] & (d_new < d_min)
        best_j = np.where(upd, j, best_j).astype(np.int32)
        d_min = np.where(upd, d_new, d_min)
        taken = taken | ((pos == sj_pos_c[cluster_of]) & use[cluster_of])
    counts = np.zeros((nm, m_ways), np.int64)
    np.add.at(counts, (cluster_of, best_j), 1)
    return best_j, seeds, counts, d1


# Tail levels at or below this many member rows run on the host.  On the
# accelerator the threshold scales by 128/d, because the host pass is
# O(P * d) while a device level costs mostly dispatch.  Both values were set
# on an earlier device and have not been re-measured on the GPU.
# `_host_split_tail_rows` is the shared knob; CPU-backend builds keep the
# flat constant (there the "device" IS the host).
_HOST_SPLIT_MAX_P = 1 << 17

# f32 elements of one (rows, C) distance workspace of the XLA closure pass
# (~1 GB): bounds its row groups.
_REPLICA_WORKSPACE_ELEMS = 1 << 28


def _tail_rows_for(platform: str, d: int) -> int:
    """The host-tail row threshold for a backend/dimension pair — see
    ``HierarchicalClustering._host_split_tail_rows``."""
    if not routes(platform).host_tail_scaled:
        return _HOST_SPLIT_MAX_P
    return max(1 << 14, (_HOST_SPLIT_MAX_P * 128) // max(d, 128))


class ResidentCountDrift(RuntimeError):
    """Device assignment disagrees with host bookkeeping in a resident
    subdivision — a correctness sentinel.  The resident-path fallback guard
    re-raises this (masking it behind a silent upload-path redo would hide
    a real kernel regression behind correct-but-doubled-cost builds)."""


@functools.partial(
    jax.jit, static_argnames=("metric", "num_segments", "m_ways")
)
def _split_level_resident(
    X, gci, seg_map, offs, seed_valid, metric: str, num_segments: int,
    m_ways: int,
):
    """Device-RESIDENT level split: membership tables are built on device
    from the persistent per-point assignment vector ``gci`` instead of being
    re-uploaded per level (the ~11 big 1M-scale levels each paid a ~6 MB table upload + a P-row assign pull + a host sort; this
    kernel's per-level wire traffic is the KB-scale ``seg_map``/``offs``
    inputs and the (S, M) seeds/counts outputs).

    ``seg_map`` maps global cluster id -> level segment (-1 = not oversized,
    segments numbered by ascending cluster id, matching the host loop's
    ``oversized`` order).  ``offs[r]`` picks seed-1 as the offs-th member of
    segment r in ascending original-index order — the exact semantics of the
    host path's ``flat_members[bounds[:-1] + offs]`` (cluster member lists
    are always ascending).  The split math itself is `_split_level_core`,
    shared op-for-op with the upload path."""
    N = gci.shape[0]
    S = num_segments
    seg = seg_map[gci.astype(jnp.int32)]  # (N,) int32, -1 = not oversized
    validp = seg >= 0
    segk = jnp.where(validp, seg, S).astype(jnp.int32)
    idx = jnp.arange(N, dtype=jnp.int32)
    # Lexicographic (segment, original index) sort: front-packs the level's
    # member rows in exactly the concatenated-members order the host built.
    sort_seg, point_list = jax.lax.sort((segk, idx), num_keys=2)
    valid = sort_seg < S
    p_count = jnp.sum(valid.astype(jnp.int32))
    # Padding rows mirror the host tables: point 0, segment 0 (masked by
    # p_count inside the core, like the host path's zero padding).
    cluster_of = jnp.where(valid, sort_seg, 0)
    point_list = jnp.where(valid, point_list, 0).astype(jnp.int32)
    seg_counts = jax.ops.segment_sum(
        validp.astype(jnp.int32), jnp.where(validp, seg, 0),
        num_segments=S,
    )
    seg_start = jnp.cumsum(seg_counts) - seg_counts  # exclusive
    c1_pos = jnp.clip(seg_start + offs.astype(jnp.int32), 0, N - 1)
    c1_idx = point_list[c1_pos]  # rows >= nm are unused downstream
    assign, seeds, counts, d1 = _split_level_core(
        X, point_list, cluster_of, p_count, c1_idx, seed_valid, metric,
        num_segments=S, m_ways=m_ways,
    )
    return assign, seeds, counts, d1, point_list, cluster_of, p_count


@functools.partial(jax.jit, static_argnames=("m_ways",), donate_argnums=(0,))
def _apply_level_assign(
    gci, point_list, cluster_of, assign, child_map, p_count, m_ways: int
):
    """Scatter a level's child assignments back into the persistent
    per-point cluster-id vector: ``gci[point_list[i]] = child_map[seg_i *
    m_ways + child_i]`` for the level's valid rows.  ``child_map`` carries
    the host's global-id allocation for every (segment, child) slot."""
    N = gci.shape[0]
    pos = jnp.arange(N, dtype=jnp.int32)
    valid = pos < p_count
    slot = cluster_of.astype(jnp.int32) * m_ways + assign.astype(jnp.int32)
    newid = child_map[slot]
    tgt = jnp.where(valid, point_list, N)  # out-of-range rows drop
    return gci.at[tgt].set(newid, mode="drop")


@functools.partial(jax.jit, static_argnames=("metric", "closure", "num_segments"))
def _split_level_flat(
    X, point_list, cluster_of, valid, c1_idx, metric: str, boundary_threshold,
    closure: bool, num_segments: int,
):
    """Batched binary split of every oversized cluster at a level
    (create_subclusters, hierarchical.rs:107-135, level-synchronous).

    Flat segment formulation: ``point_list`` (P,) concatenates all member
    indices grouped by cluster, ``cluster_of`` (P,) names each member's
    segment, ``c1_idx`` (S,) is the first seed (a random member) per cluster.
    Memory is O(P d) regardless of cluster-size skew — the earlier (S, L)
    padded form materialized a 16 GB gather on a 1M build when one cluster
    dominated a level.

    Returns (m1, m2 (P,) child membership, c2_idx (S,) second seeds,
    degenerate (S,) flags, d1 (P,) seed-1 distances for the host-side
    balanced fallback).
    """
    P = point_list.shape[0]
    pts = X[point_list]  # (P, d)
    c1v = X[c1_idx]  # (S, d)
    d1 = rowwise_distance(pts, c1v[cluster_of], metric)  # (P,)

    # Farthest member from c1 becomes the second seed (hierarchical.rs:111-126);
    # argmax via segment_max + first-position-at-max.
    is_c1 = point_list == c1_idx[cluster_of]
    d1m = jnp.where(valid & ~is_c1, d1, -jnp.inf)
    seg_max = jax.ops.segment_max(d1m, cluster_of, num_segments=num_segments)
    pos = jnp.arange(P, dtype=jnp.int32)
    at_max = valid & ~is_c1 & (d1m == seg_max[cluster_of])
    c2_pos = jax.ops.segment_min(
        jnp.where(at_max, pos, P), cluster_of, num_segments=num_segments
    )
    c2_pos = jnp.clip(c2_pos, 0, P - 1)
    c2_idx = point_list[c2_pos]
    c2v = X[c2_idx]
    d2 = rowwise_distance(pts, c2v[cluster_of], metric)

    # 2-way assignment; ties go to the first seed (the reference's fold keeps
    # the earlier index, hierarchical.rs:316-326).  In-split closure only in
    # 'nested' (reference-parity) mode.
    best2 = d2 < d1
    if closure:
        cc = rowwise_distance(c1v, c2v, metric)[cluster_of]  # (P,)
        bt = boundary_threshold.astype(ACCUM_DTYPE)
        m1 = valid & (~best2 | (best2 & (d1 < bt * d2) & (cc >= d1)))
        m2 = valid & (best2 | (~best2 & (d2 < bt * d1) & (cc >= d2)))
    else:
        m1 = valid & ~best2
        m2 = valid & best2

    # Degenerate split (SURVEY.md quirk 6): child equals parent or is empty;
    # the host applies an exact balanced median split on d1 for those.
    ones = valid.astype(jnp.int32)
    cnt = jax.ops.segment_sum(ones, cluster_of, num_segments=num_segments)
    cnt1 = jax.ops.segment_sum(m1.astype(jnp.int32), cluster_of, num_segments=num_segments)
    cnt2 = jax.ops.segment_sum(m2.astype(jnp.int32), cluster_of, num_segments=num_segments)
    degenerate = (cnt1 == cnt) | (cnt2 == cnt) | (cnt1 == 0) | (cnt2 == 0)
    return m1, m2, c2_idx, degenerate, d1


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------


def replica_pass_groups(X, base, cents, metric: str, boundary_threshold,
                        n_extra: int, soar_lambda: float = 0.0):
    """The one-device closure pass over row groups, as the build runs it:
    a list of (first row, ids (g, n_extra), scores (g, n_extra)) host
    arrays.  Each group's (group, C) distance workspaces stay under ~1 GB;
    every output row depends only on its own (X[r], base[r]), so any
    grouping is bit-identical.

    Euclidean groups run ``_final_replica_pass`` — the program the mesh
    build runs per shard.  (A single fori_loop program over all groups
    returned replica sets that disagree with a float64 reference on
    ~0.16% of rows at 1M x 128 on an H100, where this form agrees.)
    Elementwise metrics (L1/Linf) have no matmul factorization: they run
    UNFUSED (see _replica_select_from_dists)."""
    from spfresh_tpu.utils.xfer import timed_pull

    n = X.shape[0]
    C = max(1, int(cents.shape[0]))
    group = min(n, max(256, _REPLICA_WORKSPACE_ELEMS // C))
    bt = jnp.float32(boundary_threshold)
    base_dev = jnp.asarray(base, jnp.int32)
    metric = canonical_metric(metric)
    tiles = []
    for s in range(0, n, group):
        e = min(s + group, n)
        Xg = X[s:e]
        bg = base_dev[s:e]
        if metric == EUCLIDEAN:
            idx, dists = _final_replica_pass(
                Xg, bg, cents, metric, bt, n_extra, soar_lambda=soar_lambda
            )
        else:
            D = pairwise_distance(Xg, cents, metric)
            Cb = jnp.take(cents, bg, axis=0)
            CC = pairwise_distance(Cb, cents, metric)
            idx, dists = _replica_select_from_dists(
                D, CC, bg, bt, n_extra, soar_lambda=soar_lambda
            )
        tiles.append((s, timed_pull(idx), timed_pull(dists)))
    return tiles


class HierarchicalClustering:
    """Mirror of HierarchicalClustering (hierarchical.rs:43-71).

    ``mesh``: optional ``jax.sharding.Mesh`` — the build's hot loops
    (assign + medoid, subdivision levels) then run data-sharded over the mesh
    with psum/pmax/pmin collectives, the device analogue of the
    reference's rayon pools (hierarchical.rs:144,261,302).  Results are
    identical to the single-device path.

    ``corpus_layout`` (mesh builds only): "sharded" (default) keeps n/S
    corpus rows per chip — global-row accesses run as psum-contribution
    gathers, and an S-chip mesh can build a corpus larger than one chip's
    HBM.  "replicated" keeps a full corpus copy per chip (no gather
    collectives, and the builder can hand the device corpus to the
    zero-upload view pack).  Both are bit-identical to single-device."""

    def __init__(
        self, params: ClusteringParams, data, mesh=None,
        corpus_layout: str = "sharded",
    ):
        self.params = params
        self.mesh = mesh
        if corpus_layout not in ("sharded", "replicated"):
            raise ValueError(f"unknown corpus_layout {corpus_layout!r}")
        if params.replication == "nested" or params.max_split_ways == 2:
            # The binary (reference-parity) split path runs the plain kernel
            # over the mesh array; it needs whole-corpus gathers, so the
            # corpus stays replicated there.
            corpus_layout = "replicated"
        self._corpus_layout = corpus_layout if mesh is not None else "single"
        # Host copy kept for the small-level subdivision fallback (the
        # caller's array — np.asarray is no-copy for f32 numpy input); the
        # mesh path always needs one for sharding/padding.
        if mesh is not None:
            self._host_data = np.asarray(data, np.float32)
        else:
            self._host_data = (
                np.asarray(data, np.float32) if isinstance(data, np.ndarray) else None
            )
        # bf16 corpus wire (halves the dominant one-time upload).  Applied
        # IDENTICALLY on the mesh and single-device paths — the host mirror
        # must see the SAME rounded coordinates as the device kernels, or
        # host tail-level splits would diverge from device levels and a mesh
        # build would differ from a single-device build of the same config.
        wire_arr = None
        if (
            params.wire_dtype not in (None, "float32")
            and self._host_data is not None
        ):
            import ml_dtypes

            wire_arr = np.asarray(self._host_data).astype(ml_dtypes.bfloat16)
            self._host_data = wire_arr.astype(np.float32)
        # The corpus upload is the build's dominant transfer: route it
        # through the xfer accounting so the bench can report copy time
        # beside compute time.
        from spfresh_tpu.utils.xfer import STATS, timed_put

        if mesh is not None:
            import time as _time

            from spfresh_tpu.parallel.cluster_step import replicate, shard_rows

            src = wire_arr if wire_arr is not None else self._host_data
            t0 = _time.perf_counter()
            if self._corpus_layout == "sharded":
                # n/S corpus rows per chip.  Padding rows are copies of row
                # 0: ties break to the smaller (real) row id everywhere, so
                # padding can never win a medoid/seed or join a segment.
                S = mesh.devices.size
                n0 = src.shape[0]
                n_pad = ((n0 + S - 1) // S) * S
                if n_pad != n0:
                    src = np.concatenate(
                        [src, np.repeat(src[:1], n_pad - n0, axis=0)]
                    )
                self.data = shard_rows(mesh, src).astype(ACCUM_DTYPE)
            else:
                self.data = replicate(mesh, src).astype(ACCUM_DTYPE)
            jax.block_until_ready(self.data)
            STATS.account_h2d(src.nbytes, _time.perf_counter() - t0)
        elif wire_arr is not None:
            self.data = timed_put(wire_arr).astype(ACCUM_DTYPE)
        elif isinstance(data, jax.Array):
            self.data = jnp.asarray(data, dtype=ACCUM_DTYPE)  # already on device
        else:
            self.data = timed_put(
                self._host_data
                if self._host_data is not None
                else np.asarray(data, np.float32)
            ).astype(ACCUM_DTYPE)
        if self.data.ndim != 2:
            raise ValueError(f"data must be 2-d, got shape {self.data.shape}")
        # True corpus size (self.data may carry mesh-padding rows).
        self._n = int(
            self._host_data.shape[0]
            if self._host_data is not None
            else self.data.shape[0]
        )
        self.clusters: List[Cluster] = []
        seed = params.rng_seed if params.rng_seed is not None else np.random.SeedSequence().entropy % (2**63)
        self._seed = int(seed) & 0x7FFFFFFFFFFFFFFF
        self._key = jax.random.key(self._seed)

    def _level_rng(self, stream: int) -> np.random.Generator:
        """Deterministic host RNG for per-level draws (fold_in analogue)."""
        return np.random.Generator(
            np.random.Philox(key=np.uint64(self._seed ^ (stream * 0x9E3779B9)))
        )

    # -- public API (fit / labels), parity with hierarchical.rs:65-71,215-246

    def fit(self) -> "HierarchicalClustering":
        n = self._n
        k = self.params.initial_k
        if k > n:
            raise ValueError(f"initial_k={k} exceeds number of points n={n}")
        cap = self.params.desired_cluster_size
        if cap is None:
            # Builder default: round(0.18 * n) (spann_builder.rs:48-49).
            cap = max(1, int(round(0.18 * n)))

        import os

        from spfresh_tpu.utils import PhaseTimer

        # Always profile: the per-phase barriers cost microseconds and the
        # bench reports every build second by phase.  SPF_PROFILE only
        # controls log verbosity.
        timer = PhaseTimer()
        self._timer = timer

        def _phase(name):
            return timer.phase(name, block=True)

        with _phase("fit/init"):
            self._initialize_clusters(k)
        with _phase("fit/assign+medoid"):
            if self.mesh is not None:
                self._assign_and_update_sharded()
            elif self.params.replication == "nested":
                # Closure masks are multi-membership: keep the two-step path.
                self._assign_points()
                self._update_centroids()
            else:
                self._assign_and_update_fused()
        with _phase("fit/subdivide"):
            self._subdivide_clusters(int(cap))
        if self.params.replication == "final":
            with _phase("fit/replica_pass"):
                self._finalize_replication()
        if os.environ.get("SPF_PROFILE"):
            timer.report()
        return self

    def labels(self) -> np.ndarray:
        """One hard label per point: among clusters *containing* the point,
        the nearest centroid; ties -> lowest cluster index
        (hierarchical.rs:215-246).  Deliberate fix vs. the reference: we do
        not default unvisited points to cluster 0 — the reference's init quirk
        can label a point with a cluster it is not a member of.  Points not in
        any cluster (impossible after fit()) would raise."""
        n = self._n
        cent_vecs = self.centroid_vectors()
        pts, cls = [], []
        for ci, c in enumerate(self.clusters):
            pts.append(c.points)
            cls.append(np.full(len(c.points), ci, dtype=np.int64))
        pts = np.concatenate(pts)
        cls = np.concatenate(cls)
        if self._host_data is not None:
            # Tie-deciding distances from the host mirror for EVERY layout:
            # numpy and XLA reductions round differently at near-ties, so
            # mixing them (host for sharded, device otherwise) could flip a
            # replica's label between layouts and break the advertised
            # mesh <-> single-device bit-equality.
            d = _np_rowdist(
                self._host_data[pts],
                np.asarray(cent_vecs, np.float32)[cls],
                self.params.metric,
            )
        else:
            d = np.asarray(
                rowwise_distance(self.data[pts], cent_vecs[cls], self.params.metric)
            )
        order = np.lexsort((cls, d, pts))  # by point, then dist, then cluster
        pts_o = pts[order]
        first = np.ones(len(pts_o), dtype=bool)
        first[1:] = pts_o[1:] != pts_o[:-1]
        labels = np.zeros(n, dtype=np.int64)
        labels[pts_o[first]] = cls[order][first]
        return labels

    def centroid_vectors(self) -> jnp.ndarray:
        if self._corpus_layout == "sharded":
            # Row-sharded corpus: gather the C rows on the HOST mirror (the
            # same bf16-rounded grid as the device rows) and replicate —
            # a C-row cross-shard gather for every caller would serialize
            # on collectives for a few MB.
            from spfresh_tpu.parallel.cluster_step import replicate

            idx_np = np.asarray(
                [c.centroid_idx for c in self.clusters], np.int64
            )
            return replicate(
                self.mesh, self._host_data[idx_np].astype(np.float32)
            )
        idx = jnp.asarray([c.centroid_idx for c in self.clusters], dtype=jnp.int32)
        return self.data[idx]

    # -- internals

    def _initialize_clusters(self, k: int) -> None:
        if self.params.initialization_method == RANDOM:
            # choose_multiple without replacement (hierarchical.rs:200-210)
            idx = jax.random.choice(
                jax.random.fold_in(self._key, 0),
                self._n,
                shape=(k,),
                replace=False,
            )
            idx = np.asarray(idx)
        elif self._corpus_layout == "sharded":
            from spfresh_tpu.parallel.build import kmeanspp_init_sharded

            idx = np.asarray(
                kmeanspp_init_sharded(
                    self.mesh, self._key, self.data, k,
                    self.params.metric, self._n,
                )
            )
        else:
            idx = np.asarray(
                _kmeanspp_init(self._key, self.data, k, self.params.metric)
            )
        self.clusters = [
            Cluster(int(i), np.empty((0,), np.int64), 0) for i in idx
        ]

    def _assign_points(self) -> None:
        if self.params.replication == "nested":
            mask = np.asarray(
                _assign_with_closure(
                    self.data,
                    self.centroid_vectors(),
                    self.params.metric,
                    jnp.float32(self.params.boundary_threshold),
                )
            )
            for j, c in enumerate(self.clusters):
                c.points = np.flatnonzero(mask[:, j]).astype(np.int64)
        else:
            # Hard assignment: replicas are added once at the end
            # (_finalize_replication), not compounded through the hierarchy.
            D = pairwise_distance(self.data, self.centroid_vectors(), self.params.metric)
            best = np.asarray(jnp.argmin(D, axis=1))
            for j, c in enumerate(self.clusters):
                c.points = np.flatnonzero(best == j).astype(np.int64)

    def _assign_and_update_fused(self) -> None:
        """Hard assignment + medoid round as ONE device call (the unfused
        pair pulled the argmin, rebuilt the membership mask on the host,
        and uploaded it back — see `_assign_medoid_fused`).  Bit-identical
        to `_assign_points()` + `_update_centroids()` (tested)."""
        old = jnp.asarray([c.centroid_idx for c in self.clusters], jnp.int32)
        best_d, new_d = _assign_medoid_fused(
            self.data, self.centroid_vectors(), old,
            k=len(self.clusters), metric=self.params.metric,
        )
        best = np.asarray(best_d)
        new = np.asarray(new_d)
        for j, c in enumerate(self.clusters):
            c.points = np.flatnonzero(best == j).astype(np.int64)
            c.centroid_idx = int(new[j])

    def _assign_and_update_sharded(self) -> None:
        """Mesh path: one fused assign + medoid round over the data axis
        (psum segment sums, collective medoid argmin) — replaces
        _assign_points + _update_centroids with identical results."""
        from spfresh_tpu.parallel.cluster_step import shard_rows, sharded_cluster_step

        n = self._host_data.shape[0]
        S = self.mesh.devices.size
        n_pad = ((n + S - 1) // S) * S
        if self._corpus_layout == "sharded":
            X_sh = self.data  # already row-sharded + mesh-padded on device
        else:
            Xpad = self._host_data
            if n_pad != n:
                # Pad with copies of row 0: ties break to the smaller (real)
                # row id, so padding can never win a medoid or change a mask
                # column.
                Xpad = np.concatenate(
                    [Xpad, np.repeat(Xpad[:1], n_pad - n, axis=0)]
                )
            X_sh = shard_rows(self.mesh, Xpad)
        mask, _, rows = sharded_cluster_step(
            self.mesh,
            X_sh,
            self.centroid_vectors(),
            boundary_threshold=self.params.boundary_threshold,
            metric=self.params.metric,
            closure=self.params.replication == "nested",
            return_rows=True,
        )
        mask = np.asarray(mask)[:n]
        rows = np.asarray(rows)
        for j, c in enumerate(self.clusters):
            c.points = np.flatnonzero(mask[:, j]).astype(np.int64)
            if 0 <= rows[j] < n:
                c.centroid_idx = int(rows[j])

    def _replica_pass_xla(self, base, cents, n_extra: int,
                          bf16_wire: bool = False):
        # Value-lossless bf16 inputs when the corpus rode the bf16 wire —
        # see _finalize_replication (cents arrives already cast).
        X_rep = self.data.astype(jnp.bfloat16) if bf16_wire else self.data
        return replica_pass_groups(
            X_rep, base, cents, self.params.metric,
            self.params.boundary_threshold, n_extra,
            soar_lambda=float(self.params.soar_lambda or 0.0),
        )

    def _finalize_replication(self) -> None:
        """SPANN multi-replica assignment: one global closure pass adding at
        most max_replicas - 1 replicas per point on top of its base cluster."""
        n_extra = min(self.params.max_replicas - 1, len(self.clusters) - 1)
        if n_extra <= 0:
            return
        import contextlib

        from spfresh_tpu.utils.xfer import timed_pull

        # Sub-phases: fit/replica_pass mixes the device scan, the result
        # pull, and host assembly.
        timer = getattr(self, "_timer", None)

        def _p(name):
            return (
                timer.phase(name, block=True)
                if timer is not None else contextlib.nullcontext()
            )

        n = self._n
        # bf16 replica inputs when the corpus rode the bf16 wire: the device
        # coordinates are exactly bf16-representable then, so the cast is
        # value-LOSSLESS, and every Euclidean route (single device, mesh
        # twin) sees the SAME inputs — bf16 x bf16 products are exact in the
        # f32 accumulator, so the mesh <-> single-device bit-equality is
        # unchanged, while the matmul runs at the bf16 rate.  Exact-f32
        # builds (wire_dtype float32/None) keep full f32 arithmetic, and
        # L1/Linf stay f32 too (elementwise bf16 SUBTRACTION is not value-
        # exact, unlike the Euclidean expansion's products).
        bf16_wire = (
            self.params.wire_dtype not in (None, "float32")
            and canonical_metric(self.params.metric) == EUCLIDEAN
        )
        with _p("replica/host_base"):
            base = np.zeros(n, np.int64)
            for ci, c in enumerate(self.clusters):
                base[c.points] = ci
            if self.mesh is None and self._host_data is not None:
                # Single-device: assemble the exact-C centroid matrix on the
                # HOST mirror and ship it in ONE put (a device gather
                # `self.data[idx]` plus cast would cost extra compiles per
                # build, since C is data-dependent).
                from spfresh_tpu.utils.xfer import timed_put

                idx_np = np.asarray(
                    [c.centroid_idx for c in self.clusters], np.int64
                )
                ch = self._host_data[idx_np]  # f32; bf16-grid if bf16 wire
                if bf16_wire:
                    import ml_dtypes

                    ch = ch.astype(ml_dtypes.bfloat16)
                cents = timed_put(ch)
            else:
                cents = self.centroid_vectors()
                if bf16_wire:
                    cents = cents.astype(jnp.bfloat16)
        extra_pts: List[np.ndarray] = []
        extra_cls: List[np.ndarray] = []
        extra_d: List[np.ndarray] = []
        if self.mesh is not None:
            # Mesh path: the pass is pure data parallelism — shard the rows,
            # replicate the centroids, no collectives (cluster_step.py).
            from spfresh_tpu.parallel.cluster_step import (
                shard_rows, sharded_replica_pass,
            )

            S = self.mesh.devices.size
            n_pad = ((n + S - 1) // S) * S
            bp = base
            if n_pad != n:  # padding rows' replicas are sliced off below
                bp = np.concatenate([bp, np.repeat(bp[:1], n_pad - n)])
            rep_dtype = jnp.bfloat16 if bf16_wire else ACCUM_DTYPE
            if self._corpus_layout == "sharded":
                # row-sharded + mesh-padded already (cast is device-local)
                X_sh = self.data.astype(rep_dtype)
            else:
                Xp = self._host_data
                if n_pad != n:
                    Xp = np.concatenate(
                        [Xp, np.repeat(Xp[:1], n_pad - n, axis=0)]
                    )
                X_sh = shard_rows(self.mesh, Xp.astype(rep_dtype))
            with _p("replica/device+pull"):
                idx, dists = sharded_replica_pass(
                    self.mesh,
                    X_sh,
                    shard_rows(self.mesh, bp.astype(np.int32)),
                    cents,
                    self.params.metric,
                    self.params.boundary_threshold,
                    n_extra,
                    soar_lambda=float(self.params.soar_lambda or 0.0),
                )
                tiles = [(0, timed_pull(idx)[:n], timed_pull(dists)[:n])]
        else:
            metrics.inc("build.replica_engine.xla")
            with _p("replica/device+pull"):
                tiles = self._replica_pass_xla(
                    base, cents, n_extra, bf16_wire=bf16_wire,
                )
        with _p("replica/host_budget"):
            for s, idx, dists in tiles:
                valid = np.isfinite(dists)
                pts = np.broadcast_to(
                    np.arange(s, s + idx.shape[0])[:, None], idx.shape
                )
                extra_pts.append(pts[valid])
                extra_cls.append(idx[valid])
                extra_d.append(dists[valid])
            if not extra_pts:
                return
            pts = np.concatenate(extra_pts)
            cls = np.concatenate(extra_cls)
            dst = np.concatenate(extra_d)
            # Per-cluster replica budget: members <= ceil(overflow * cap);
            # the closest replicas win the remaining slots.
            cap = self.params.desired_cluster_size
            if cap is None:
                cap = max(1, int(round(0.18 * n)))
            limit = max(int(np.ceil(self.params.replica_overflow * cap)), 1)
            # by cluster, then dist ascending (u64-key radix; ~2.3x lexsort)
            order = budget_sort(cls, dst)
            pts, cls = pts[order], cls[order]
            bounds = np.searchsorted(cls, np.arange(len(self.clusters) + 1))
            for ci, c in enumerate(self.clusters):
                budget = max(0, limit - len(c.points))
                extra = pts[
                    bounds[ci]
                    : bounds[ci] + min(budget, bounds[ci + 1] - bounds[ci])
                ]
                if len(extra):
                    c.points = np.sort(np.concatenate([c.points, extra]))

    def _update_centroids(self) -> None:
        n = self.data.shape[0]
        k = len(self.clusters)
        mask = np.zeros((n, k), dtype=bool)
        for j, c in enumerate(self.clusters):
            mask[c.points, j] = True
        old = jnp.asarray([c.centroid_idx for c in self.clusters], jnp.int32)
        new = np.asarray(
            _medoid_update(self.data, jnp.asarray(mask), old, self.params.metric)
        )
        for j, c in enumerate(self.clusters):
            c.centroid_idx = int(new[j])

    def _subdivide_clusters(self, cap: int) -> None:
        if self.params.replication == "nested" or self.params.max_split_ways == 2:
            # Reference-parity binary splits (in-split closure needs the
            # 2-seed geometry).
            self._subdivide_binary(cap)
        else:
            self._subdivide_multiway(cap)

    def _subdivide_multiway(self, cap: int) -> None:
        """Level-synchronous M-way subdivision: every oversized cluster at a
        level splits into ~ceil(len/cap) (<= max_split_ways) children in one
        batched device call.  Replaces ~log2 binary levels with ~log8 levels
        — fewer rounds, fewer padded-shape compile buckets."""
        import contextlib

        timer = getattr(self, "_timer", None)

        def _p(name, block=False):
            return (
                timer.phase(name, block=block)
                if timer is not None else contextlib.nullcontext()
            )

        level = 0
        tail_max = self._host_split_tail_rows()
        # Resident default: ON for accelerators (no per-level member-table
        # uploads or pulls), OFF on the CPU backend where its full-N
        # per-level compute is a measured 1.5x pessimization (36 s vs 24 s
        # at 300k, 1-core host).  The platform table (core/platform.py)
        # holds the default; SPF_SUBDIV_RESIDENT=0/1 overrides it.
        use_res = os.environ.get("SPF_SUBDIV_RESIDENT")
        if use_res is None:
            platform = next(iter(self.data.devices())).platform
            use_res = "1" if routes(platform).resident_subdivision else "0"
        if use_res != "0":
            # Device-resident big levels: membership stays on device as one
            # assignment vector; the host sees only per-cluster counts.
            # Hands the <=128k-row tail back to this loop (the host tail
            # path is SHARED with the mesh build — bit-equality contract).
            # A device failure here fails the build.
            if self.mesh is None:
                level = self._subdivide_multiway_resident(cap, _p, level)
            elif self._corpus_layout == "sharded":
                # Mesh analogue: the per-point vector lives SHARDED like the
                # corpus; per-level member-table uploads disappear the same
                # way.  (The replicated layout keeps the upload path — it
                # exists for the zero-upload view-pack handoff.)
                level = self._subdivide_multiway_resident_mesh(cap, _p, level)
        while True:
            oversized = [i for i, c in enumerate(self.clusters) if len(c) > cap]
            if not oversized:
                break
            level += 1
            with _p("subdiv/host_prep"):
                members = [self.clusters[i].points for i in oversized]
                nm = len(members)
                lens = np.array([len(m) for m in members])
                m_c, M, S, seed_valid, offs = self._level_split_params(
                    lens, cap, level
                )
                bounds = np.zeros(nm + 1, np.int64)
                np.cumsum(lens, out=bounds[1:])
                P = int(bounds[-1])
                Ppad = next_pow2(P)
                point_list = np.zeros(Ppad, np.int32)
                # int16 wire when the segment count allows: halves the
                # cluster-table upload (values < S; the kernel upcasts).
                co_dtype = np.int16 if S <= (1 << 15) else np.int32
                cluster_of = np.zeros(Ppad, co_dtype)
                flat_members = np.concatenate(members)
                point_list[:P] = flat_members
                cluster_of_np = np.repeat(np.arange(nm, dtype=np.int32), lens)
                cluster_of[:P] = cluster_of_np
                c1_idx = np.zeros(S, np.int32)
                c1_idx[:nm] = flat_members[bounds[:-1] + offs]
            if P <= tail_max and self._host_data is not None:
                # Tail level: a few stragglers — the device round-trip costs
                # ~1.4 s for <0.1 s of math; run the same algorithm on host.
                with _p("subdiv/host_level"):
                    assign, seeds, counts, d1 = _split_level_multiway_host(
                        self._host_data, flat_members, cluster_of_np,
                        c1_idx[:nm], m_c, self.params.metric,
                        nm=nm, m_ways=M,
                    )
                self._finish_multiway_level(
                    oversized, members, lens, bounds, m_c, M, nm,
                    cluster_of_np, flat_members, assign, seeds, counts, d1,
                    _p,
                )
                continue
            from spfresh_tpu.utils.xfer import timed_pull, timed_put

            if self.mesh is not None and self._corpus_layout == "sharded":
                # Row-sharded corpus: the level runs with psum-contribution
                # seed gathers and original-position tie-breaks; outputs come
                # back as numpy in member order (transfers accounted inside).
                from spfresh_tpu.parallel.build import sharded_split_level_rows

                with _p("subdiv/kernel", block=True):
                    assign, seeds, counts, d1 = sharded_split_level_rows(
                        self.mesh, self.data, flat_members, cluster_of_np,
                        c1_idx, seed_valid, self.params.metric,
                        num_segments=S, m_ways=M,
                    )
                counts = counts[:nm]
                self._finish_multiway_level(
                    oversized, members, lens, bounds, m_c, M, nm,
                    cluster_of_np, flat_members, assign, seeds, counts, d1,
                    _p,
                )
                continue
            with _p("subdiv/upload"):
                if self.mesh is None:
                    # Member tables cost ~6 MB/level at 1M scale — account
                    # them as link time, not kernel time.  (The former 1 MB
                    # bool valid table is now a device scalar; cluster_of
                    # rides int16.)
                    pl_dev = timed_put(point_list)
                    co_dev = timed_put(cluster_of)
            with _p("subdiv/kernel", block=True):
                if self.mesh is not None:
                    from spfresh_tpu.parallel.build import sharded_split_level

                    valid = np.zeros(Ppad, bool)
                    valid[:P] = True
                    assign, seeds, counts, d1 = sharded_split_level(
                        self.mesh, self.data, point_list,
                        cluster_of.astype(np.int32), valid,
                        c1_idx, seed_valid, self.params.metric,
                        num_segments=S, m_ways=M,
                    )
                else:
                    assign, seeds, counts, d1 = _split_level_multiway(
                        self.data,
                        pl_dev,
                        co_dev,
                        jnp.int32(P),
                        jnp.asarray(c1_idx),
                        jnp.asarray(seed_valid),
                        self.params.metric,
                        num_segments=S,
                        m_ways=M,
                    )
            with _p("subdiv/transfer"):
                assign = timed_pull(assign)[:P]
                seeds = timed_pull(seeds)
                counts = timed_pull(counts)[:nm]
            self._finish_multiway_level(
                oversized, members, lens, bounds, m_c, M, nm,
                cluster_of_np, flat_members, assign, seeds, counts, d1, _p,
            )

    def _host_split_tail_rows(self) -> int:
        """Row threshold below which subdivision levels run on the host.
        128/d-scaled on accelerators (the numpy pass is O(P * d) on one
        core; device levels are dispatch-dominated), flat on the CPU
        backend.  Purely a work-placement knob: the host and device level
        drivers are bit-identical (tested), so moving the boundary never
        changes a build's output."""
        return _tail_rows_for(
            next(iter(self.data.devices())).platform, int(self.data.shape[1])
        )

    def _level_split_params(self, lens: np.ndarray, cap: int, level: int):
        """The per-level split recipe shared by the upload, resident, and
        mesh-resident drivers — ONE copy, because their bit-equality
        contract depends on byte-identical ``m_c``/``M``/``S``/``seed_valid``
        and the same per-level Philox draws.  ``offs`` comes from a HOST RNG
        derived from the build seed + level: a per-level device randint
        would cost a device round trip per level; host draws keep the same-seed determinism contract across all
        drivers.  Returns (m_c, M, S, seed_valid, offs) with ``offs`` shaped
        (nm,) — resident callers pad it to S themselves."""
        nm = len(lens)
        m_c = np.ceil(lens / cap).astype(np.int64)
        m_c = np.clip(m_c, 2, min(self.params.max_split_ways, int(lens.max())))
        m_c = np.minimum(m_c, lens)
        M = next_pow2(int(m_c.max()))  # bucket: 2 / 4 / 8 variants
        S = next_pow2(nm)
        seed_valid = np.zeros((S, M), bool)
        seed_valid[:nm] = np.arange(M)[None, :] < m_c[:, None]
        offs = self._level_rng(1000 + level).integers(0, np.maximum(lens, 1))
        return m_c, M, S, seed_valid, offs

    def _materialize_from_gci(
        self, gci_np: np.ndarray, counts_h, seed_h, depth_h, driver: str
    ) -> None:
        """Build ``self.clusters`` from a final per-point assignment vector:
        one global stable sort (members come out ascending, the order every
        downstream consumer assumes), cross-checked against the host
        bookkeeping — a mismatch raises the ``ResidentCountDrift`` sentinel
        (never swallowed by the fallback guard)."""
        n_ids = len(counts_h)
        order = np.argsort(gci_np, kind="stable").astype(np.int64)
        cnt = np.bincount(gci_np, minlength=n_ids)
        if cnt.tolist() != counts_h:
            raise ResidentCountDrift(
                f"{driver} subdivision count drift: device assignment "
                "disagrees with host bookkeeping"
            )
        parts = np.split(order, np.cumsum(cnt)[:-1])
        self.clusters = [
            Cluster(seed_h[cid], parts[cid], depth_h[cid])
            for cid in range(n_ids)
        ]

    def _subdivide_multiway_resident(self, cap: int, _p, level: int) -> int:
        """Device-resident subdivision driver for the big levels (single
        device).  The per-point cluster-id vector lives on device across
        levels; each level costs two dispatches and KB-scale transfers
        instead of a ~6 MB table upload + P-row assign pull + host sort.
        Seeds, RNG draws, tie-breaks, degenerate
        handling and child-id numbering replicate `_subdivide_multiway` /
        `_finish_multiway_level` exactly, so the resulting clusters are
        identical to the upload path's (and to a mesh build's — the shared
        host tail still runs below `_host_split_tail_rows()` rows).

        Returns the level counter reached; the caller's loop continues the
        host Philox stream from there."""
        from spfresh_tpu.utils.xfer import timed_pull, timed_put

        tail_max = self._host_split_tail_rows()
        counts_h = [len(c) for c in self.clusters]
        big = [c for c in counts_h if c > cap]
        if not big or (
            sum(big) <= tail_max and self._host_data is not None
        ):
            return level  # nothing resident-sized to do
        with _p("subdiv/host_prep"):
            n = self._n
            gci_np = np.zeros(n, np.int32)
            for j, c in enumerate(self.clusters):
                gci_np[c.points] = j
            gci = timed_put(gci_np)
            seed_h = [int(c.centroid_idx) for c in self.clusters]
            depth_h = [int(c.depth) for c in self.clusters]
            # Level-INVARIANT kernel shapes: with exact shapes every level's
            # fresh (seg_map-length, S, M) combination forces a fresh XLA
            # compile (~2 kernels x ~11 levels at 1M).
            # m_ways pads to the build's max bucket and S/seg_map pad to
            # build constants, so `_split_level_resident` and
            # `_apply_level_assign` compile ONCE per build.  Correctness is
            # unchanged: padded child columns are seed_valid-masked (zero
            # counts, never assigned), padded segments carry no members,
            # and padded seg_map slots are -1.  Extra device work is a few
            # masked full-N distance passes per level — microseconds of VPU
            # time against tens of seconds of compiles.
            M_pad = next_pow2(max(2, int(self.params.max_split_ways)))
            # nm at any level <= (points inside oversized clusters) / (cap+1),
            # and that point population only shrinks level over level.
            seg_budget = max(1, int(sum(big)) // (cap + 1))
            S_pad = next_pow2(seg_budget)
            seg_pad = next_pow2(max(len(counts_h), 4 * seg_budget))
        while True:
            counts_arr = np.asarray(counts_h, np.int64)
            oversized = np.flatnonzero(counts_arr > cap)
            if oversized.size == 0:
                break
            lens = counts_arr[oversized]
            P = int(lens.sum())
            if P <= tail_max and self._host_data is not None:
                break  # hand the tail to the shared host path
            level += 1
            with _p("subdiv/host_prep"):
                nm = int(oversized.size)
                m_c, M, S, seed_valid, offs_nm = self._level_split_params(
                    lens, cap, level
                )
                # Pad the host tables to the build-constant kernel shapes.
                S_use = S_pad if S_pad >= S else next_pow2(nm)  # safety net
                if len(counts_h) > seg_pad:
                    seg_pad = next_pow2(len(counts_h))
                offs = np.zeros(S_use, np.int32)
                offs[:nm] = offs_nm
                sv_pad = np.zeros((S_use, M_pad), bool)
                sv_pad[:nm, :M] = seed_valid[:nm]
                seg_map = np.full(seg_pad, -1, np.int32)
                seg_map[oversized] = np.arange(nm, dtype=np.int32)
            with _p("subdiv/upload"):
                seg_map_d = timed_put(seg_map)
                offs_d = timed_put(offs)
                sv_d = timed_put(sv_pad)
            with _p("subdiv/kernel", block=True):
                assign, seeds_d, counts_d, d1, point_list, cluster_of, p_count = (
                    _split_level_resident(
                        self.data, gci, seg_map_d, offs_d, sv_d,
                        self.params.metric, num_segments=S_use, m_ways=M_pad,
                    )
                )
            with _p("subdiv/transfer"):
                seeds = timed_pull(seeds_d)[:nm]
                counts = timed_pull(counts_d)[:nm].astype(np.int64)
            with _p("subdiv/host_build"):
                bounds = np.zeros(nm + 1, np.int64)
                np.cumsum(lens, out=bounds[1:])
                degenerate = counts.max(axis=1) == lens
                child_map = np.zeros(S_use * M_pad, np.int32)
                fix_idx: List[np.ndarray] = []
                fix_val: List[np.ndarray] = []
                if degenerate.any():
                    # ONE bulk pull each (per-cluster device slices would
                    # compile a fresh dynamic-slice per unique length).
                    pl_np = np.asarray(point_list)
                    d1_np = np.asarray(d1)
                for r, ci in enumerate(oversized):
                    ci = int(ci)
                    depth = depth_h[ci] + 1
                    if degenerate[r]:
                        # All members in one child (duplicate-heavy): exact
                        # balanced quantile split on d1, as the host path.
                        lo, hi = int(bounds[r]), int(bounds[r + 1])
                        mem = pl_np[lo:hi].astype(np.int64)
                        order_r = np.argsort(d1_np[lo:hi], kind="stable")
                        qparts = np.array_split(mem[order_r], int(m_c[r]))
                        childs = [
                            (int(p[0]), len(p), None) for p in qparts if len(p)
                        ]
                        child_map[r * M_pad : (r + 1) * M_pad] = ci  # fixed below
                        for p in qparts[:1]:
                            fix_idx.append(p.astype(np.int32))
                            fix_val.append(np.full(len(p), ci, np.int32))
                        nid = len(counts_h)
                        for p in qparts[1:]:
                            if not len(p):
                                continue
                            fix_idx.append(p.astype(np.int32))
                            fix_val.append(np.full(len(p), nid, np.int32))
                            nid += 1
                    else:
                        childs = [
                            (int(seeds[r, j]), int(counts[r, j]), j)
                            for j in range(M_pad)
                            if counts[r, j] > 0
                        ]
                    # child 0 keeps the parent's id; the rest get fresh ids
                    # appended in (r, j) order — the classic numbering.
                    sd0, cnt0, j0 = childs[0]
                    seed_h[ci], counts_h[ci], depth_h[ci] = sd0, cnt0, depth
                    if j0 is not None:
                        child_map[r * M_pad + j0] = ci
                    for sd, cnt2, j in childs[1:]:
                        nid = len(counts_h)
                        if j is not None:
                            child_map[r * M_pad + j] = nid
                        seed_h.append(sd)
                        counts_h.append(cnt2)
                        depth_h.append(depth)
            with _p("subdiv/kernel"):
                cm_d = timed_put(child_map)
                gci = _apply_level_assign(
                    gci, point_list, cluster_of, assign, cm_d, p_count, M_pad
                )
                if fix_idx:
                    # Pow2-padded drop-mode scatter: bounds the compile
                    # variants of the degenerate fix-up to log2 buckets.
                    fi = np.concatenate(fix_idx)
                    fv = np.concatenate(fix_val)
                    pad = next_pow2(len(fi))
                    fi2 = np.full(pad, n, np.int32)  # n = out of range: drop
                    fi2[: len(fi)] = fi
                    fv2 = np.zeros(pad, np.int32)
                    fv2[: len(fv)] = fv
                    gci = gci.at[jnp.asarray(fi2)].set(
                        jnp.asarray(fv2), mode="drop"
                    )
        with _p("subdiv/transfer"):
            gci_np = timed_pull(gci)
        with _p("subdiv/host_build"):
            self._materialize_from_gci(
                gci_np, counts_h, seed_h, depth_h, "resident"
            )
        return level

    def _subdivide_multiway_resident_mesh(self, cap: int, _p, level: int) -> int:
        """Mesh twin of ``_subdivide_multiway_resident`` for the row-sharded
        corpus layout (round-4 lever 5): the persistent per-point cluster-id
        vector lives SHARDED over the mesh like the corpus; each big level
        costs two collective dispatches and KB-scale transfers instead of
        the per-level member-table upload ``sharded_split_level_rows`` pays
        (host deal + (P,)-scale pid/co/opos tables per level).  Seeds, RNG
        draws, tie-breaks, degenerate handling and child-id numbering
        replicate the single-device drivers exactly, so mesh and
        single-device builds stay bit-identical (tested on the virtual
        8-device CPU mesh)."""
        from jax.sharding import NamedSharding, PartitionSpec
        from spfresh_tpu.parallel.build import (
            _resident_apply_call,
            _resident_split_call,
        )
        from spfresh_tpu.utils.xfer import timed_pull, timed_put

        tail_max = self._host_split_tail_rows()
        counts_h = [len(c) for c in self.clusters]
        big = [c for c in counts_h if c > cap]
        if not big or (
            sum(big) <= tail_max and self._host_data is not None
        ):
            return level  # nothing resident-sized to do
        mesh = self.mesh
        axis = mesh.axis_names[0]
        shard = NamedSharding(mesh, PartitionSpec(axis))
        rep = NamedSharding(mesh, PartitionSpec())
        n = self._n
        n_pad = int(self.data.shape[0])  # corpus carries mesh padding rows
        with _p("subdiv/host_prep"):
            gci_np = np.zeros(n_pad, np.int32)
            for j, c in enumerate(self.clusters):
                gci_np[c.points] = j
            gci = timed_put(gci_np, shard)
            seed_h = [int(c.centroid_idx) for c in self.clusters]
            depth_h = [int(c.depth) for c in self.clusters]
            # Level-invariant kernel shapes — same reasoning (and same
            # padding semantics) as `_subdivide_multiway_resident`: one
            # compile of the split/apply collectives per build, not one
            # per level.
            M_pad = next_pow2(max(2, int(self.params.max_split_ways)))
            seg_budget = max(1, int(sum(big)) // (cap + 1))
            S_pad = next_pow2(seg_budget)
            seg_pad = next_pow2(max(len(counts_h), 4 * seg_budget))
        while True:
            counts_arr = np.asarray(counts_h, np.int64)
            oversized = np.flatnonzero(counts_arr > cap)
            if oversized.size == 0:
                break
            lens = counts_arr[oversized]
            P = int(lens.sum())
            if P <= tail_max and self._host_data is not None:
                break  # hand the tail to the shared host path
            level += 1
            with _p("subdiv/host_prep"):
                nm = int(oversized.size)
                m_c, M, S, seed_valid, offs_nm = self._level_split_params(
                    lens, cap, level
                )
                S_use = S_pad if S_pad >= S else next_pow2(nm)  # safety net
                if len(counts_h) > seg_pad:
                    seg_pad = next_pow2(len(counts_h))
                offs = np.zeros(S_use, np.int32)
                offs[:nm] = offs_nm
                sv_pad = np.zeros((S_use, M_pad), bool)
                sv_pad[:nm, :M] = seed_valid[:nm]
                seg_map = np.full(seg_pad, -1, np.int32)
                seg_map[oversized] = np.arange(nm, dtype=np.int32)
            with _p("subdiv/upload"):
                seg_map_d = timed_put(seg_map, rep)
                offs_d = timed_put(offs, rep)
                sv_d = timed_put(sv_pad, rep)
            with _p("subdiv/kernel", block=True):
                assign_row, seeds_d, counts_d, d1_row = _resident_split_call(
                    self.data, gci, seg_map_d, offs_d, sv_d,
                    mesh=mesh, axis=axis, metric=self.params.metric,
                    num_segments=S_use, m_ways=M_pad, n=n,
                )
            with _p("subdiv/transfer"):
                seeds = timed_pull(seeds_d)[:nm]
                counts = timed_pull(counts_d)[:nm].astype(np.int64)
            with _p("subdiv/host_build"):
                degenerate = counts.max(axis=1) == lens
                child_map = np.zeros(S_use * M_pad, np.int32)
                quantile_fix = []  # (parent_cid, [new child ids])
                for r, ci in enumerate(oversized):
                    ci = int(ci)
                    depth = depth_h[ci] + 1
                    if degenerate[r]:
                        # All members in one child (duplicate-heavy): exact
                        # balanced quantile split on d1, as the host paths.
                        # Members materialize AFTER the apply below (all of
                        # segment r's rows then carry exactly id ci), but
                        # the child ids must be allocated HERE, in strict
                        # r-order, to match the single-device numbering.
                        # m_c <= lens structurally, so array_split yields
                        # exactly m_c[r] non-empty parts — the child count
                        # is known without the member rows; seeds/counts
                        # are placeholders until the fix block.
                        child_map[r * M_pad : (r + 1) * M_pad] = ci
                        depth_h[ci] = depth
                        nid_list = []
                        for _ in range(int(m_c[r]) - 1):
                            nid_list.append(len(counts_h))
                            seed_h.append(-1)
                            counts_h.append(0)
                            depth_h.append(depth)
                        quantile_fix.append((ci, nid_list))
                        continue
                    childs = [
                        (int(seeds[r, j]), int(counts[r, j]), j)
                        for j in range(M_pad)
                        if counts[r, j] > 0
                    ]
                    sd0, cnt0, j0 = childs[0]
                    seed_h[ci], counts_h[ci], depth_h[ci] = sd0, cnt0, depth
                    child_map[r * M_pad + j0] = ci
                    for sd, cnt2, j in childs[1:]:
                        nid = len(counts_h)
                        child_map[r * M_pad + j] = nid
                        seed_h.append(sd)
                        counts_h.append(cnt2)
                        depth_h.append(depth)
            with _p("subdiv/kernel"):
                cm_d = timed_put(child_map, rep)
                gci = _resident_apply_call(
                    gci, seg_map_d, assign_row, cm_d,
                    mesh=mesh, axis=axis, m_ways=M_pad, n=n,
                )
            if quantile_fix:
                # Rare degenerate path: the single-device drivers read the
                # member tables straight off the split kernel; here the
                # sharded apply first parks every degenerate-segment row at
                # the parent id, then ONE full pull + host quantile split +
                # one re-put fills the reserved ids (cost bounded by
                # degenerate frequency, not level count).
                with _p("subdiv/transfer"):
                    gci_np = np.array(timed_pull(gci))  # writable copy
                    d1_np = timed_pull(d1_row)
                with _p("subdiv/host_build"):
                    for ci, nid_list in quantile_fix:
                        # Scan only the real rows: mesh padding rows keep
                        # their initial id (0) and must never join a split.
                        mem = np.flatnonzero(gci_np[:n] == ci).astype(np.int64)
                        order_r = np.argsort(d1_np[mem], kind="stable")
                        qparts = np.array_split(mem[order_r], len(nid_list) + 1)
                        seed_h[ci] = int(qparts[0][0])
                        counts_h[ci] = len(qparts[0])
                        for nid, p_rows in zip(nid_list, qparts[1:]):
                            gci_np[p_rows] = nid
                            seed_h[nid] = int(p_rows[0])
                            counts_h[nid] = len(p_rows)
                with _p("subdiv/upload"):
                    gci = timed_put(gci_np, shard)
        # Materialize from the final assignment vector — sliced to the real
        # rows (mesh padding rows keep their initial id and must not count).
        with _p("subdiv/transfer"):
            gci_np = timed_pull(gci)[:n]
        with _p("subdiv/host_build"):
            self._materialize_from_gci(
                gci_np, counts_h, seed_h, depth_h, "mesh resident"
            )
        return level

    def _finish_multiway_level(
        self, oversized, members, lens, bounds, m_c, M, nm,
        cluster_of_np, flat_members, assign, seeds, counts, d1, _p,
    ) -> None:
        """Host bookkeeping shared by the device and host split paths:
        detect degenerate (no-progress) splits, build the child clusters via
        one global stable sort, and splice them into ``self.clusters``."""
        P = flat_members.shape[0]
        with _p("subdiv/host_build"):
            assign = np.asarray(assign)[:P]
            seeds = np.asarray(seeds)
            counts = np.asarray(counts)[:nm]
            # No progress = everything landed in one child (duplicate-
            # heavy cluster): exact balanced quantile split on d1 instead.
            degenerate = counts.max(axis=1) == lens
            d1 = np.asarray(d1)[:P] if degenerate.any() else None
            # Vectorized child building: one global stable sort by
            # (cluster, child), then bincount + split — no per-cluster
            # loops over P.
            key = cluster_of_np * M + assign
            order = np.argsort(key, kind="stable")
            sorted_members = flat_members[order]
            cnt = np.bincount(key, minlength=nm * M)
            parts = np.split(sorted_members, np.cumsum(cnt)[:-1])
            new_tail: List[Cluster] = []
            for r, ci in enumerate(oversized):
                depth = self.clusters[ci].depth + 1
                if degenerate[r]:
                    lo, hi = int(bounds[r]), int(bounds[r + 1])
                    mem = members[r]
                    order_r = np.argsort(d1[lo:hi], kind="stable")
                    qparts = np.array_split(mem[order_r], int(m_c[r]))
                    childs = [(int(p[0]), p) for p in qparts if len(p)]
                else:
                    childs = [
                        (int(seeds[r, j]), parts[r * M + j])
                        for j in range(M)
                        if len(parts[r * M + j])
                    ]
                self.clusters[ci] = Cluster(childs[0][0], childs[0][1], depth)
                for cidx, pts_ in childs[1:]:
                    new_tail.append(Cluster(cidx, pts_, depth))
            self.clusters.extend(new_tail)

    def _subdivide_binary(self, cap: int) -> None:
        level = 0
        closure = self.params.replication == "nested"
        while True:
            oversized = [i for i, c in enumerate(self.clusters) if len(c) > cap]
            if not oversized:
                break
            level += 1
            members = [self.clusters[i].points for i in oversized]
            nm = len(members)
            lens = np.array([len(m) for m in members])
            bounds = np.zeros(nm + 1, np.int64)
            np.cumsum(lens, out=bounds[1:])
            P = int(bounds[-1])
            Ppad = next_pow2(P)
            S = next_pow2(nm)  # pad segments too: bounds compile count
            point_list = np.zeros(Ppad, np.int32)
            cluster_of = np.zeros(Ppad, np.int32)
            valid = np.zeros(Ppad, bool)
            flat_members = np.concatenate(members)
            point_list[:P] = flat_members
            valid[:P] = True
            cluster_of[:P] = np.repeat(np.arange(nm, dtype=np.int32), lens)
            # Random member as seed 1 per cluster (points.choose,
            # hierarchical.rs:110); deterministic HOST draw (see the
            # multiway path — a per-level device randint costs a device
            # round trip for nothing).
            offs = self._level_rng(1000 + level).integers(
                0, np.maximum(lens, 1)
            )
            c1_idx = np.zeros(S, np.int32)
            c1_idx[:nm] = flat_members[bounds[:-1] + offs]
            m1, m2, c2_idx, degenerate, d1 = _split_level_flat(
                self.data,
                jnp.asarray(point_list),
                jnp.asarray(cluster_of),
                jnp.asarray(valid),
                jnp.asarray(c1_idx),
                self.params.metric,
                jnp.float32(self.params.boundary_threshold),
                closure=closure,
                num_segments=S,
            )
            m1 = np.asarray(m1)[:P]
            m2 = np.asarray(m2)[:P]
            c2_idx = np.asarray(c2_idx)
            degenerate = np.asarray(degenerate)
            # d1 is only consumed by the balanced fallback for degenerate
            # clusters (rare); skip the (P,) f32 device->host pull otherwise.
            d1 = np.asarray(d1) if degenerate[: len(members)].any() else None
            # Vectorized child building: per-cluster boolean slicing costs
            # seconds of host time at thousands of clusters per level; one
            # global mask-select + reduceat/split is C-speed.
            cnt1 = np.add.reduceat(m1.astype(np.int64), bounds[:-1])
            cnt2 = np.add.reduceat(m2.astype(np.int64), bounds[:-1])
            parts1 = np.split(flat_members[m1], np.cumsum(cnt1)[:-1])
            parts2 = np.split(flat_members[m2], np.cumsum(cnt2)[:-1])
            new_tail: List[Cluster] = []
            for r, ci in enumerate(oversized):
                depth = self.clusters[ci].depth + 1
                if degenerate[r]:
                    # Exact balanced median split by distance to seed 1
                    # (guaranteed progress on duplicate-heavy clusters).
                    lo, hi = int(bounds[r]), int(bounds[r + 1])
                    mem = members[r]
                    order = np.argsort(d1[lo:hi], kind="stable")
                    half = (len(mem) + 1) // 2
                    sel = np.zeros(len(mem), bool)
                    sel[order[:half]] = True
                    pts1, pts2 = mem[sel], mem[~sel]
                else:
                    pts1, pts2 = parts1[r], parts2[r]
                self.clusters[ci] = Cluster(int(c1_idx[r]), pts1, depth)
                new_tail.append(Cluster(int(c2_idx[r]), pts2, depth))
            self.clusters.extend(new_tail)
