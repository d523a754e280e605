"""Chebyshev plateau diagnosis.

BASELINE config 4's Chebyshev row plateaus at recall ~0.65 regardless of
probe depth.  This experiment separates the two candidate causes at a
tractable scale (default 100k x 960):

1. ROUTING LOSS — probing by L-inf centroid proximity misses the clusters
   that hold the true L-inf neighbors.  Signature: full-probe recall is
   high, partial-probe recall is low.
2. NEIGHBOR INSTABILITY — L-inf over ~1000 coordinates concentrates so
   hard that the 10-NN boundary gaps are below storage/matmul rounding, so
   the "true" 10-NN set is not stable under any implementation.  Signature:
   the id-recall vs tie-tolerant distance-recall gap, and the GT gap
   statistics vs the bf16 rounding width.

Measurements per storage dtype (f32 and bf16):
  - nprobe sweep incl. FULL probe (the f32 full-probe row must be 1.0 —
    the standing exactness invariant, here exercised at 960-d scale);
  - id-recall (GT id overlap) AND dist-recall (returned ids whose true
    f32 L-inf distance is within (1+1e-6) of the GT k-th distance — the
    tie-tolerant notion: an id with an equal-or-better distance is not a
    miss, it is an arbitrary tie-break).

GT gap statistics: the fraction of queries whose k/k+1 boundary gap is
below bf16 relative rounding (2^-8) predicts the bf16 flip rate; the mean
count of top-k members within rounding of the boundary bounds the id-recall
ceiling of ANY bf16 engine.

Mixed-metric variant: route + cluster by Euclidean, final rerank by
Chebyshev on the L2 candidate pool (candidates = search(k=pool) on the L2
index, host-reranked by L-inf).  If L2 routing recovers recall that L-inf
routing cannot, the fix is mixed-metric routing; if not, the corpus's
L-inf neighborhood structure is genuinely unroutable.

Usage:
    python benchmarks/chebyshev_probe.py                  # 100k x 960 on the card
    python benchmarks/chebyshev_probe.py --n 5000 --dim 64 --nq 128  # smoke
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spfresh_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

_SEED = 12345


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def chebyshev_host(queries: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    """Exact f32 L-inf distances, one query row at a time (host, small Q)."""
    out = np.empty((queries.shape[0], vecs.shape[0]), np.float32)
    for i, q in enumerate(queries):
        out[i] = np.max(np.abs(vecs - q[None, :]), axis=1)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=960)
    ap.add_argument("--nq", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--spread", type=float, default=0.7)
    ap.add_argument("--cluster-size", type=int, default=256)
    ap.add_argument("--pool", type=int, default=100,
                    help="L2 candidate pool size for the mixed-metric rerank")
    args = ap.parse_args()

    from spfresh_tpu.eval import recall_at_k
    from spfresh_tpu.index import Config, SpannIndexBuilder, brute_force_search

    n, nq, k, d = args.n, args.nq, args.k, args.dim
    rng = np.random.default_rng(_SEED)
    n_centers = max(64, n // 1000)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)

    def draw(m):
        a = rng.integers(0, n_centers, size=m)
        return (centers[a] + args.spread * rng.standard_normal((m, d))).astype(
            np.float32
        )

    data = draw(n)
    queries = draw(nq)

    # -- ground truth (f32, k+1 for the boundary gap) ----------------------
    gt_key = f"cheb_gt_n{n}_d{d}_nq{nq}_k{k + 1}_s{args.spread}_seed{_SEED}"
    gt_path = os.path.join("/tmp/spann_bench_gt", gt_key + ".npz")
    if os.path.exists(gt_path):
        z = np.load(gt_path)
        gt_d, gt_i = z["gt_d"], z["gt_i"]
        log(f"ground truth: cached ({gt_path})")
    else:
        t0 = time.perf_counter()
        gt_d, gt_i = brute_force_search(data, queries, k + 1, metric="Chebyshev")
        log(f"ground truth: {time.perf_counter() - t0:.1f}s")
        os.makedirs(os.path.dirname(gt_path), exist_ok=True)
        np.savez(gt_path, gt_d=gt_d, gt_i=gt_i)

    # -- gap statistics vs rounding ----------------------------------------
    # brute_force_search returns L-inf distances directly for Chebyshev.
    bnd = gt_d[:, k] - gt_d[:, k - 1]  # boundary gap (k+1-th minus k-th)
    rel = bnd / np.maximum(gt_d[:, k - 1], 1e-12)
    eps_bf16 = 2.0 ** -8
    frac_flip = float(np.mean(rel < eps_bf16))
    # Members of the top-k within bf16 rounding of the boundary: any bf16
    # engine may swap these with the other side.  d_boundary = gt_d[:, k].
    within = gt_d[:, :k] > (gt_d[:, k:k + 1] * (1.0 - eps_bf16))
    unstable_per_q = within.sum(axis=1)
    id_ceiling_bf16 = 1.0 - float(np.mean(unstable_per_q)) / k / 2.0
    stats = {
        "rel_gap_median": float(np.median(rel)),
        "rel_gap_p10": float(np.percentile(rel, 10)),
        "frac_queries_gap_below_bf16": frac_flip,
        "mean_topk_within_bf16_of_boundary": float(np.mean(unstable_per_q)),
        "approx_bf16_id_recall_ceiling": round(id_ceiling_bf16, 4),
    }
    log(f"gap stats: {stats}")

    # Tie-tolerant distance recall: an id whose TRUE f32 L-inf distance is
    # <= (1 + tol) * gt kth distance counts as a hit.
    def dist_recall(ids: np.ndarray) -> float:
        hits = 0
        tot = 0
        thresh = gt_d[:, k - 1] * (1.0 + 1e-6)
        for i in range(nq):
            got = ids[i][ids[i] >= 0]
            tot += k
            if len(got) == 0:
                continue
            dd = np.max(np.abs(data[got] - queries[i][None, :]), axis=1)
            hits += int(np.sum(dd <= thresh[i]))
        return hits / tot

    gt_ids = gt_i[:, :k]

    def sweep(index, label, nprobes):
        rows = []
        for nprobe in nprobes:
            np_eff = min(nprobe, index.num_clusters)
            ids, _ = index.search(queries, k, nprobe=np_eff)  # warm
            t0 = time.perf_counter()
            ids, _ = index.search(queries, k, nprobe=np_eff)
            dt = time.perf_counter() - t0
            r_id = recall_at_k(ids, gt_ids, k)
            r_dist = dist_recall(ids)
            rows.append(
                {
                    "nprobe": int(np_eff),
                    "full": np_eff == index.num_clusters,
                    "id_recall": round(float(r_id), 4),
                    "dist_recall": round(float(r_dist), 4),
                    "qps": round(nq / dt, 0),
                }
            )
            log(
                f"{label:18s} nprobe={np_eff:5d}{'(full)' if np_eff == index.num_clusters else '      '} "
                f"id_recall={r_id:.4f} dist_recall={r_dist:.4f} qps={nq / dt:,.0f}"
            )
            if np_eff == index.num_clusters:
                break
        return rows

    def build(metric, storage):
        cfg = Config.from_dict(
            {
                "clustering_params": {
                    "distance_metric": metric,
                    "initialization_method": "KMeans++",
                    "initial_k": 16,
                    "desired_cluster_size": args.cluster_size,
                    "rng_seed": 42,
                },
                "output_path": "/tmp/spann_cheb_idx",
                "storage_dtype": storage,
                "search": {"query_batch_size": 1024},
            }
        )
        t0 = time.perf_counter()
        index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
        log(
            f"build {metric}/{storage}: {time.perf_counter() - t0:.1f}s "
            f"clusters={index.num_clusters} stored_x={index.num_vectors / n:.2f}"
        )
        return index

    nprobes = [16, 64, 256, 1024, 10**9]
    out = {"n": n, "dim": d, "spread": args.spread, "gap_stats": stats}

    idx_f32 = build("Chebyshev", "float32")
    out["cheb_f32"] = sweep(idx_f32, "cheb/f32", nprobes)
    idx_f32.drop_device_views()
    del idx_f32

    idx_bf16 = build("Chebyshev", "bfloat16")
    out["cheb_bf16"] = sweep(idx_bf16, "cheb/bf16", nprobes)
    idx_bf16.drop_device_views()
    del idx_bf16

    # -- mixed-metric: L2 routing + clustering, host L-inf rerank ----------
    idx_l2 = build("Euclidean", "float32")
    pool = args.pool
    rows = []
    for nprobe in (16, 64, 256):
        np_eff = min(nprobe, idx_l2.num_clusters)
        cand, _ = idx_l2.search(queries, pool, nprobe=np_eff)  # warm
        t0 = time.perf_counter()
        cand, _ = idx_l2.search(queries, pool, nprobe=np_eff)
        ids = np.full((nq, k), -1, np.int64)
        for i in range(nq):
            got = cand[i][cand[i] >= 0]
            if len(got) == 0:
                continue
            dd = np.max(np.abs(data[got] - queries[i][None, :]), axis=1)
            ord_ = np.argsort(dd, kind="stable")[:k]
            ids[i, : len(ord_)] = got[ord_]
        dt = time.perf_counter() - t0
        r_id = recall_at_k(ids, gt_ids, k)
        r_dist = dist_recall(ids)
        rows.append(
            {
                "nprobe": int(np_eff),
                "pool": pool,
                "id_recall": round(float(r_id), 4),
                "dist_recall": round(float(r_dist), 4),
                "qps": round(nq / dt, 0),
            }
        )
        log(
            f"l2route+linf-rerank nprobe={np_eff:5d} pool={pool} "
            f"id_recall={r_id:.4f} dist_recall={r_dist:.4f} qps={nq / dt:,.0f}"
        )
    out["l2_route_linf_rerank"] = rows
    idx_l2.drop_device_views()

    print(json.dumps(out))


if __name__ == "__main__":
    main()
