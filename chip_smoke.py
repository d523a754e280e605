#!/usr/bin/env python3
"""Smoke run of the index on one NVIDIA GPU, through the public entry points.

    python chip_smoke.py                # phases 1-6 on one card
    python chip_smoke.py --four-cards   # only the 4-card sharded phase

Phases (one process, one card):

1. Build 1,000,000 x 128 f32 (SIFT1M shape, bf16 storage, cluster size 256,
   KMeans++) with ``SpannIndexBuilder``; exact top-10 ground truth for 10,000
   queries from ``brute_force_search``; sweep ``nprobe`` through
   ``SpannIndex.search`` until recall@10 >= 0.90.
2. Exactness: a 50,000-row index from the same corpus; full-probe search
   gives recall 1.0 on both search layouts (CSR and slab).
3. Search stage 2 (``slab_distances``: d=128 bf16, d=960 f32, the int8
   residual tier; all three metrics) and ``pairwise_distance`` at
   4096 x 12,288 x 960, as XLA compiles them for the card, against float64
   numpy.
4. Live updates: ``SpFreshIndex`` over 100,000 rows takes 10,000 inserts and
   5,000 deletes; every insert is its own top-1, no deleted id comes back,
   and the layout the updated index serves agrees with the other one.
5. Disk tier: the phase-1 index saved packed and opened with
   ``LazySpannIndex`` keeps recall@10 >= 0.90 at the phase-1 ``nprobe``.
6. Build passes at full size: with the phase-1 centroids, the out-of-core
   nearest-centroid scan and the in-core and out-of-core closure-replica
   passes over all 1,000,000 rows, each checked on 3,000 sampled rows
   against a float64 reference; then an out-of-core build of the corpus
   (``build_sample_rows`` set) with its ``oc/*`` profile, coverage and
   recall.

Data is a seeded Gaussian mixture (``spfresh_tpu.eval.mixture_corpus``).
Every line that carries a number also carries the card's name and power
limit.  The last line of stdout is one JSON object, printed only when every
phase passed.  Without a GPU the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from spfresh_tpu.utils.compile_cache import REPO_ROOT, enable_compile_cache  # noqa: E402

K = 10
TARGET_RECALL = 0.90
N_BASE, N_QUERIES, DIM = 1_000_000, 10_000, 128
N_EXACT, N_EXACT_QUERIES = 50_000, 2_000
N_LIVE, N_INSERT, N_DELETE = 100_000, 10_000, 5_000
N_PASS_CHECK = 3_000  # rows of the full-size build passes checked in float64
N_OC_SAMPLE = 200_000  # rows the out-of-core build clusters
# Stage-2 cases: (label, C, pad, d, Q, nprobe, slab dtype name).
RERANK_CASES = (
    ("d=128 bf16", 4096, 272, 128, 1024, 16, "bfloat16"),
    ("d=960 f32", 1024, 136, 960, 256, 16, "float32"),
    ("d=128 int8 residual", 4096, 272, 128, 1024, 16, "int8"),
)
PAIRWISE_SHAPE = (4096, 12_288, 960)  # GIST: queries x corpus tile x d
CARD = "unknown card"


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def build(data, storage_dtype: str, mesh=None, **clustering):
    from spfresh_tpu.eval import sift1m_config
    from spfresh_tpu.index import SpannIndexBuilder

    t0 = time.perf_counter()
    index = SpannIndexBuilder(
        sift1m_config(storage_dtype, **clustering), mesh=mesh
    ).with_data(data).build(save=False)
    return index, time.perf_counter() - t0


def timed_search(index, queries, nprobe: int, **kw):
    """(ids, best-of-3 warm wall) of one ``index.search`` over ``queries``."""
    ids, _ = index.search(queries, K, nprobe=nprobe, **kw)  # compile
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        index.search(queries, K, nprobe=nprobe, **kw)
        best = min(best, time.perf_counter() - t0)
    return ids, best


def exact_recall(found, gt_i, gt_d, corpus, queries):
    """(plain recall, recall counting exact-distance ties as hits).  A miss
    is a tie when the returned id's exact f32 distance equals the k-th true
    distance up to the rounding of two summation orders."""
    from spfresh_tpu.eval import recall_at_k

    plain = recall_at_k(found, gt_i, K)
    hits = 0
    for q in range(len(found)):
        want = set(gt_i[q, :K].tolist())
        for pid in found[q, :K]:
            if pid in want:
                hits += 1
            elif pid >= 0:
                dd = float(np.sum((corpus[pid] - queries[q]) ** 2))
                kth = float(gt_d[q, K - 1])
                hits += dd <= kth + 1e-5 * max(kth, 1e-12)
    return plain, hits / (len(found) * K)


# -- phases -------------------------------------------------------------------


def phase_build_search(data, queries, state):
    from spfresh_tpu.eval import NPROBE_SWEEP, recall_at_k
    from spfresh_tpu.index import brute_force_search

    n, d = data.shape
    index, wall = build(data, "bfloat16")
    say(f"phase 1: first build of {n} x {d} (bf16 storage): {wall:.3f} s, "
        f"{index.num_clusters} clusters, stored x{index.num_vectors / n:.4f}")
    for name, secs in sorted(index.build_profile.items(), key=lambda kv: -kv[1]):
        say(f"phase 1:   build_profile {name}: {secs:.3f} s")
    t0 = time.perf_counter()
    gt_d, gt_i = brute_force_search(data, queries, K)
    say(f"phase 1: exact ground truth for {len(queries)} queries: "
        f"{time.perf_counter() - t0:.3f} s")
    best = None
    for nprobe in NPROBE_SWEEP:
        if nprobe > index.num_clusters:
            break
        ids, dt = timed_search(index, queries, nprobe)
        rec = recall_at_k(ids, gt_i, K)
        say(f"phase 1: nprobe={nprobe} recall@10={rec:.4f} "
            f"qps={len(queries) / dt:.1f}")
        if rec >= TARGET_RECALL:
            best = (nprobe, rec)
            break
    check(best is not None, f"recall@10 never reached {TARGET_RECALL}")
    state.update(index=index, gt_i=gt_i, nprobe=best[0])


def phase_exactness(data, queries, state):
    from spfresh_tpu.index import brute_force_search

    sub = data[:N_EXACT]
    q = queries[:N_EXACT_QUERIES]
    index, wall = build(sub, "float32")
    gt_d, gt_i = brute_force_search(sub, q, K)
    say(f"phase 2: {N_EXACT}-row build {wall:.3f} s, {index.num_clusters} clusters")
    for engine in ("slab", "csr"):
        ids, _ = index.search(q, K, nprobe=index.num_clusters, engine=engine)
        plain, tie_aware = exact_recall(ids, gt_i, gt_d, sub, q)
        say(f"phase 2: full-probe engine={engine} recall@10={plain:.6f} "
            f"(ties as hits {tie_aware:.6f})")
        check(tie_aware == 1.0, f"full-probe recall {tie_aware} on {engine}")
    state.update(exact_index=index, exact_q=q, exact_gt=(gt_d, gt_i))


def _topk_ids_match(got, ref, rtol):
    """Top-10 candidates per query agree except at distance ties."""
    Q = got.shape[0]
    fg = np.asarray(got, np.float64).reshape(Q, -1)
    fr = np.asarray(ref, np.float64).reshape(Q, -1)
    ig = np.argsort(fg, axis=1, kind="stable")[:, :K]
    ir = np.argsort(fr, axis=1, kind="stable")[:, :K]
    diff = ig != ir
    a = np.take_along_axis(fr, ig, 1)[diff]
    b = np.take_along_axis(fr, ir, 1)[diff]
    return int(diff.sum()), bool(np.all(np.abs(a - b) <= rtol * np.abs(b)))


def _numpy_slab_distances(metric, q, rows, vecs, scales=None, centered=None):
    """float64 numpy reference of ``slab_distances``."""
    v = np.asarray(vecs[rows], np.float64)  # (Q, nprobe, pad, d)
    if scales is not None:
        v = v * np.asarray(scales, np.float64)[..., None, None]
        qv = np.asarray(centered, np.float64)[:, :, None, :]
    else:
        qv = np.asarray(q, np.float64)[:, None, None, :]
    diff = np.abs(v - qv)
    if metric == "Euclidean":
        return (diff ** 2).sum(-1)
    if metric == "Manhattan":
        return diff.sum(-1)
    return diff.max(-1)


def phase_kernels(state):
    """The search stage 2 and the pairwise distances as XLA compiles them
    for the card, at real widths, against float64 numpy."""
    import jax
    import jax.numpy as jnp

    from spfresh_tpu.ops.distances import pairwise_distance, slab_distances

    rng = np.random.default_rng(7)
    rtol = 1e-5  # f32 sums of up to 1,024 terms in another order
    n_chk = 16  # queries checked against numpy (the card computes all Q)
    for label, C, pad, d, Q, nprobe, dt in RERANK_CASES:
        dt = jnp.dtype(dt)
        rows = rng.integers(0, C, (Q, nprobe)).astype(np.int32)
        q = rng.standard_normal((Q, d)).astype(np.float32)
        kw = {}
        if dt == jnp.int8:
            vecs = rng.integers(-127, 128, (C, pad, d)).astype(np.int8)
            kw = dict(
                scales=rng.uniform(0.001, 0.02, (Q, nprobe)).astype(np.float32),
                centered_queries=(0.5 * rng.standard_normal((Q, nprobe, d))
                                  ).astype(np.float32),
            )
            vecs_np = vecs
        else:
            vecs_np = np.asarray(jnp.asarray(
                rng.standard_normal((C, pad, d)), jnp.float32).astype(dt))
            vecs = vecs_np
        dev = {k2: jnp.asarray(v) for k2, v in kw.items()}
        f = jax.jit(slab_distances, static_argnums=3)
        for metric in ("Euclidean", "Manhattan", "Chebyshev"):
            got = np.asarray(jax.block_until_ready(f(
                jnp.asarray(q), jnp.asarray(rows), jnp.asarray(vecs), metric,
                **dev)))
            assert got.shape == (Q, nprobe, pad)
            ref = _numpy_slab_distances(
                metric, q[:n_chk], rows[:n_chk], vecs_np.astype(np.float32),
                kw["scales"][:n_chk] if kw else None,
                kw["centered_queries"][:n_chk] if kw else None)
            err = float(np.max(np.abs(got[:n_chk] - ref) / np.maximum(ref, 1e-30)))
            ndiff, ties_only = _topk_ids_match(got[:n_chk], ref, 1e-4)
            say(f"phase 3: slab_distances {label} {metric}: max rel err "
                f"{err:.3e} (rtol {rtol}), top-10 id mismatches {ndiff} "
                f"(all at ties: {ties_only})")
            check(err <= rtol and ties_only, f"slab_distances {label} {metric}")

    # pairwise_distance at GIST shape against float64.
    nx, ny, d = PAIRWISE_SHAPE
    x = rng.standard_normal((nx, d)).astype(np.float32)
    y = rng.standard_normal((ny, d)).astype(np.float32)
    xd, yd = jnp.asarray(x), jnp.asarray(y)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    rows_chk = rng.choice(nx, min(nx, 64), replace=False)
    for metric in ("Euclidean", "Manhattan", "Chebyshev"):
        jax.block_until_ready(pairwise_distance(xd, yd, metric))  # compile
        t0 = time.perf_counter()
        D = jax.block_until_ready(pairwise_distance(xd, yd, metric))
        secs = time.perf_counter() - t0
        D = np.asarray(D)
        if metric == "Euclidean":
            n2 = (x64 ** 2).sum(1)[:, None] + (y64 ** 2).sum(1)[None, :]
            ref = n2 - 2.0 * (x64 @ y64.T)
            err = float(np.max(np.abs(D - ref) / n2))
            bound = 1e-5  # |err| <= 1e-5 (|x|^2 + |y|^2): expansion cancellation
        else:
            ref = np.stack([
                (np.abs(x64[r] - y64).sum(1) if metric == "Manhattan"
                 else np.abs(x64[r] - y64).max(1)) for r in rows_chk
            ])
            err = float(np.max(np.abs(D[rows_chk] - ref) / np.abs(ref)))
            bound = 1e-5
        say(f"phase 3: pairwise_distance {metric} {nx}x{ny}x{d}: "
            f"{secs * 1e3:.3f} ms warm, max err {err:.3e} (bound {bound})")
        check(err <= bound, f"pairwise {metric}")


def phase_live_updates(data, workdir):
    from spfresh_tpu.lire import LireConfig, SpFreshIndex

    base = data[:N_LIVE]
    index, wall = build(base, "float32")
    say(f"phase 4: {N_LIVE}-row build {wall:.3f} s, "
        f"{index.num_clusters} clusters")
    # New vectors: unindexed rows of the same mixture, under fresh ids.
    new = data[len(data) - N_INSERT:]
    new_ids = np.arange(len(data), len(data) + N_INSERT)
    rng = np.random.default_rng(5)
    dead = np.sort(rng.choice(len(base), N_DELETE, replace=False))
    store = os.path.join(workdir, "fresh_store")
    with SpFreshIndex(
        index, store, LireConfig(max_partition_size=512, min_partition_size=16)
    ) as fresh:
        t0 = time.perf_counter()
        fresh.insert_batch(new, new_ids)
        fresh.delete_batch(dead)
        fresh.flush()
        say(f"phase 4: {N_INSERT} inserts + {N_DELETE} deletes + flush: "
            f"{time.perf_counter() - t0:.3f} s, "
            f"{fresh.index.num_clusters} clusters after")
        # An acknowledged insert must be readable: exhaustive (full-probe)
        # self-query returns it first.  At nprobe=16 the share is an ANN
        # quality figure (a split can leave a member outside its 16 nearest
        # lists), printed for information.
        full = fresh.index.num_clusters
        layout = fresh.index.search_layout()
        ids16, d16 = fresh.search(new, K, nprobe=16)
        # The other layout, repacked from the same postings, must agree.
        other = "csr" if layout == "slab" else "slab"
        ids_o, d_o = fresh.search(new, K, nprobe=16, engine=other)
        ndiff = int((ids16 != ids_o).any(axis=1).sum())
        say(f"phase 4: serving layout {layout}; rows where {other} differs "
            f"at nprobe=16: {ndiff} of {len(new)}, max distance difference "
            f"{float(np.max(np.abs(d16 - d_o), initial=0.0)):.3e}")
        check(np.allclose(d16, d_o, rtol=1e-5, atol=1e-5),
              f"layouts disagree after live updates ({ndiff} rows)")
        ids, _ = fresh.search(new, K, nprobe=full)
        self_top1 = float(np.mean(ids[:, 0] == new_ids))
        ids_dead, _ = fresh.search(base[dead], K, nprobe=full)
        dead_set = set(dead.tolist())
        leaked = sum(
            1 for row in np.concatenate([ids16, ids, ids_dead]) for v in row
            if int(v) in dead_set
        )
        say(f"phase 4: inserted vectors found as own top-1: {self_top1:.6f} "
            f"at full probe, {float(np.mean(ids16[:, 0] == new_ids)):.6f} at "
            f"nprobe=16; deleted ids returned: {leaked}")
        check(self_top1 == 1.0, "an inserted vector is not its own top-1")
        check(leaked == 0, "deleted ids came back")


def phase_disk_tier(queries, state, workdir):
    from spfresh_tpu.eval import recall_at_k
    from spfresh_tpu.index.lazy import LazySpannIndex

    index = state["index"]
    path = os.path.join(workdir, "packed_index")
    t0 = time.perf_counter()
    index.save(path, format="packed")
    say(f"phase 5: packed save {time.perf_counter() - t0:.3f} s")
    with LazySpannIndex(path) as lazy:
        say(f"phase 5: native host library loaded: {lazy._native is not None}")
        t0 = time.perf_counter()
        ids, _ = lazy.search(queries, K, nprobe=state["nprobe"])
        dt = time.perf_counter() - t0
        rec = recall_at_k(ids, state["gt_i"], K)
        say(f"phase 5: lazy search nprobe={state['nprobe']} recall@10="
            f"{rec:.4f} qps={len(queries) / dt:.1f} (first call)")
        check(rec >= TARGET_RECALL, f"lazy recall {rec}")


def _rows_of(pts, cls, dists, rows, n_extra):
    """(ids, scores) (len(rows), n_extra) of the flat replica triples
    ``pts`` (ascending), ``cls``, ``dists`` for ``rows``; +inf pads."""
    ki = np.full((len(rows), n_extra), -1, np.int64)
    kd = np.full((len(rows), n_extra), np.inf, np.float32)
    lo = np.searchsorted(pts, rows, "left")
    hi = np.searchsorted(pts, rows, "right")
    for j, (a, b) in enumerate(zip(lo, hi)):
        ki[j, : b - a] = cls[a:b]
        kd[j, : b - a] = dists[a:b]
    return ki, kd


def phase_build_passes(data, queries, state):
    """The build's nearest-centroid and closure-replica passes over the
    whole corpus, with the phase-1 centroids, on the bf16 grid the build
    uses; sampled rows against float64.  Then an out-of-core build."""
    import jax.numpy as jnp
    import ml_dtypes

    from spfresh_tpu.clustering.hierarchical import replica_pass_groups
    from spfresh_tpu.clustering.outofcore import (
        DEFAULT_TILE_ROWS, _stream_base, _stream_replicas,
    )
    from spfresh_tpu.clustering.reference import (
        nearest_mismatches, replica_mismatches,
    )
    from spfresh_tpu.eval import NPROBE_SWEEP, recall_at_k, sift1m_config
    from spfresh_tpu.index import SpannIndexBuilder
    from spfresh_tpu.utils.xfer import timed_pull, timed_put

    index = state["index"]
    params = index.config.to_clustering_params()
    n = len(data)
    bf16 = ml_dtypes.bfloat16
    cents = np.stack([index.centroids[c] for c in sorted(index.centroids)])
    cents_w = cents.astype(bf16).astype(np.float32)  # the build's wire grid
    C = len(cents_w)
    n_extra = min(params.max_replicas - 1, C - 1)
    bt, soar = params.boundary_threshold, float(params.soar_lambda or 0.0)
    rows = np.sort(np.random.default_rng(11).choice(n, N_PASS_CHECK, replace=False))
    X_rows = data[rows].astype(bf16).astype(np.float32)

    t0 = time.perf_counter()
    base, db = _stream_base(data, cents_w, params.metric, DEFAULT_TILE_ROWS,
                            True, timed_put, timed_pull)
    bad = nearest_mismatches(base[rows], db[rows], X_rows, cents_w)
    say(f"phase 6: out-of-core nearest-centroid scan, {n} rows x {C} "
        f"centroids: {time.perf_counter() - t0:.3f} s; rows off the float64 "
        f"argmin: {len(bad)} of {len(rows)}")
    check(not bad, f"nearest-centroid scan wrong on rows {rows[bad[:10]]}")

    t0 = time.perf_counter()
    tiles = replica_pass_groups(
        jnp.asarray(data.astype(bf16)), base, jnp.asarray(cents_w.astype(bf16)),
        params.metric, bt, n_extra, soar_lambda=soar)
    ki = np.concatenate([t[1] for t in tiles])
    kd = np.concatenate([t[2] for t in tiles])
    secs = time.perf_counter() - t0
    bad = replica_mismatches(ki[rows], kd[rows], X_rows, base[rows], cents_w,
                             bt, soar)
    say(f"phase 6: in-core replica pass ({len(tiles)} row groups, n_extra "
        f"{n_extra}): {secs:.3f} s; rows breaking the float64 closure rule: "
        f"{len(bad)} of {len(rows)}")
    check(not bad, f"in-core replica pass wrong on rows {rows[bad[:10]]}")

    t0 = time.perf_counter()
    pts, cls, dists = _stream_replicas(
        data, cents_w, base, db, params, n_extra, DEFAULT_TILE_ROWS, True,
        timed_put, timed_pull)
    secs = time.perf_counter() - t0
    oi, od = _rows_of(pts, cls, dists, rows, n_extra)
    bad = replica_mismatches(oi, od, X_rows, base[rows], cents_w, bt, soar)
    fin = np.isfinite(kd)
    same = sum(
        1 for r in rows
        if set(ki[r][fin[r]].tolist())
        == set(cls[np.searchsorted(pts, r, "left"):
                   np.searchsorted(pts, r, "right")].tolist())
    )
    say(f"phase 6: out-of-core replica pass: {secs:.3f} s; rows breaking the "
        f"float64 closure rule: {len(bad)} of {len(rows)}; sampled rows with "
        f"the in-core pass's replica set: {same} of {len(rows)}")
    check(not bad, f"out-of-core replica pass wrong on rows {rows[bad[:10]]}")

    cfg = sift1m_config("bfloat16")
    cfg.build_sample_rows, cfg.build_tile_rows = N_OC_SAMPLE, DEFAULT_TILE_ROWS
    cfg.validate()
    t0 = time.perf_counter()
    oc = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    wall = time.perf_counter() - t0
    say(f"phase 6: out-of-core build of {n} x {data.shape[1]} ({N_OC_SAMPLE}-row "
        f"sample): {wall:.3f} s, {oc.num_clusters} clusters, stored "
        f"x{oc.num_vectors / n:.4f}")
    for name, secs in sorted(oc.build_profile.items(), key=lambda kv: -kv[1]):
        say(f"phase 6:   build_profile {name}: {secs:.3f} s")
    cnt = np.zeros(n, np.int64)
    for ids, _ in oc.postings.values():
        cnt[np.asarray(ids)] += 1
    longest = max(len(ids) for ids, _ in oc.postings.values())
    limit = int(np.ceil(cfg.replica_overflow * 256))
    say(f"phase 6: out-of-core postings per row {cnt.min()}..{cnt.max()} "
        f"(cap {cfg.max_replicas}), longest posting {longest} (cap {limit})")
    check(cnt.min() >= 1 and cnt.max() <= cfg.max_replicas and longest <= limit,
          "out-of-core build breaks coverage or caps")
    best = None
    for nprobe in NPROBE_SWEEP:
        ids, _ = oc.search(queries, K, nprobe=nprobe)
        rec = recall_at_k(ids, state["gt_i"], K)
        say(f"phase 6: out-of-core index nprobe={nprobe} recall@10={rec:.4f}")
        if rec >= TARGET_RECALL:
            best = nprobe
            break
    check(best is not None, "out-of-core index never reached the recall target")
    oc.drop_device_views()


def _memberships(index):
    """point id -> the set of postings (named by their medoid centroid)
    holding it: primaries and closure replicas alike."""
    out = {}
    for cid, (ids, _) in index.postings.items():
        key = index.centroids[cid].tobytes()
        for i in np.asarray(ids).tolist():
            out.setdefault(i, set()).add(key)
    return out


def _compare_builds(label, data, storage, **clustering):
    """Build one-card and 4-card mesh indexes; report (and fail on) the
    points whose posting sets differ.  Returns (one-card, mesh) indexes."""
    single, wall1 = build(data, storage, **clustering)
    meshed, wall4 = build(data, storage, mesh=4, **clustering)
    m1, m4 = _memberships(single), _memberships(meshed)
    differ = sum(1 for i in m1.keys() | m4.keys() if m1.get(i) != m4.get(i))
    say(f"four cards: {label}: one-card build {wall1:.3f} s "
        f"({single.num_clusters} clusters), 4-card mesh build {wall4:.3f} s "
        f"({meshed.num_clusters} clusters); points whose posting set "
        f"differs: {differ} of {len(data)}")
    check(differ == 0, f"{label}: {differ} points differ, mesh vs one card")
    return single, meshed


def phase_four_cards(data, queries):
    """4-GPU mesh build vs the one-card build, and ShardedSpannIndex.

    Clusters and replica sets must be identical: the clustering alone
    (max_replicas=1, no replica pass, f32 and bf16) and the full build are
    compared point by point.  The mesh-built index must also reach the
    recall target at the one-card operating nprobe."""
    import jax

    from spfresh_tpu.eval import NPROBE_SWEEP, recall_at_k
    from spfresh_tpu.index import brute_force_search
    from spfresh_tpu.parallel.sharded import ShardedSpannIndex, default_mesh

    check(len(jax.devices()) == 4, f"{len(jax.devices())} devices, want 4")
    _compare_builds("f32 clustering only (max_replicas=1)", data, "float32",
                    max_replicas=1)
    _compare_builds("bf16 clustering only (max_replicas=1)", data,
                    "bfloat16", max_replicas=1)
    single, meshed = _compare_builds("bf16 full build", data, "bfloat16")
    for name, secs in sorted(meshed.build_profile.items(), key=lambda kv: -kv[1]):
        say(f"four cards:   mesh build_profile {name}: {secs:.3f} s")

    gt_d, gt_i = brute_force_search(data, queries, K)
    best = None
    for nprobe in NPROBE_SWEEP:
        ids, _ = single.search(queries, K, nprobe=nprobe)
        if recall_at_k(ids, gt_i, K) >= TARGET_RECALL:
            best = nprobe
            break
    check(best is not None, "one-card recall never reached the target")
    ids, _ = meshed.search(queries, K, nprobe=best)
    rec_mesh = recall_at_k(ids, gt_i, K)
    say(f"four cards: mesh-built index nprobe={best} recall@10={rec_mesh:.4f}")
    check(rec_mesh >= TARGET_RECALL, f"mesh-built index recall {rec_mesh}")
    sharded = ShardedSpannIndex(single, default_mesh())
    ids, dt = timed_search(sharded, queries, best)
    rec = recall_at_k(ids, gt_i, K)
    say(f"four cards: ShardedSpannIndex engine={sharded.engine} nprobe={best} "
        f"recall@10={rec:.4f} qps={len(queries) / dt:.1f}")
    check(rec >= TARGET_RECALL, f"sharded recall {rec}")

    sub, q = data[:N_EXACT], queries[:N_EXACT_QUERIES]
    small, _ = build(sub, "float32")
    sgt_d, sgt_i = brute_force_search(sub, q, K)
    ssh = ShardedSpannIndex(small, default_mesh())
    ids, _ = ssh.search(q, K, nprobe=small.num_clusters)
    plain, tie_aware = exact_recall(ids, sgt_i, sgt_d, sub, q)
    say(f"four cards: sharded full-probe recall@10={plain:.6f} "
        f"(ties as hits {tie_aware:.6f})")
    check(tie_aware == 1.0, "sharded full-probe recall below 1.0")


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=12345)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU mesh build and sharded search")
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    from spfresh_tpu.utils.card import card_name

    CARD = card_name()
    say(f"card: {CARD}; JAX {jax.__version__}; {len(devices)} x "
        f"{devices[0].device_kind}")

    from spfresh_tpu.eval import mixture_corpus

    t0 = time.perf_counter()
    data, queries = mixture_corpus(N_BASE, N_QUERIES, DIM, seed=args.seed)
    say(f"corpus {N_BASE} x {DIM} + {N_QUERIES} queries generated in "
        f"{time.perf_counter() - t0:.3f} s (seed {args.seed})")

    scratch_root = os.path.join(REPO_ROOT, ".smoke")
    os.makedirs(scratch_root, exist_ok=True)
    workdir = tempfile.mkdtemp(dir=scratch_root)
    try:
        if args.four_cards:
            phases = [("four cards", lambda: phase_four_cards(data, queries))]
        else:
            state: dict = {}
            phases = [
                ("1 build+search",
                 lambda: phase_build_search(data, queries, state)),
                ("2 exactness", lambda: phase_exactness(data, queries, state)),
                ("3 kernels", lambda: phase_kernels(state)),
                ("4 live updates", lambda: phase_live_updates(data, workdir)),
                ("5 disk tier", lambda: phase_disk_tier(queries, state, workdir)),
                ("6 build passes",
                 lambda: phase_build_passes(data, queries, state)),
            ]
        for name, fn in phases:
            t0 = time.perf_counter()
            fn()
            say(f"phase {name}: passed in {time.perf_counter() - t0:.3f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    d0 = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": d0.platform, "kind": d0.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
