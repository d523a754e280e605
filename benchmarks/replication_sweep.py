"""Replication frontier sweep (VERDICT r2 item 4).

Closure replicas buy recall at a fixed probe depth but cost HBM, slab DMA,
and rerank work linearly in the stored multiplier.  This sweep maps the
stored-x / recall / QPS frontier over the three knobs that control it —
``max_replicas`` (per-point replica cap), ``boundary_threshold`` (admission:
d(p, c_j) < bt * d(p, c_base)), and ``replica_overflow`` (per-posting
headroom) — on the bench corpus model, and prints one table row per config:

    max_rep  bt  overflow  stored_x  pad  nprobe@target  recall  qps

The reference hardcodes its closure rule (hierarchical.rs:328-346) with no
equivalent knobs; published SPANN configs run stored-x ~1.5-2.

Usage:
    python benchmarks/replication_sweep.py --n 200000          # frontier map
    python benchmarks/replication_sweep.py --n 1000000 \
        --grid "8,1.10,1.25;4,1.05,1.25"                       # confirm at 1M
"""

import argparse
import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from spfresh_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

_SEED = 12345  # same corpus family as bench.py


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--nq", type=int, default=2048)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--spread", type=float, default=0.7)
    ap.add_argument("--cluster-size", type=int, default=256)
    ap.add_argument("--target-recall", type=float, default=0.90)
    ap.add_argument("--storage-dtype", default="bfloat16")
    ap.add_argument(
        "--grid",
        default=None,
        help="';'-separated 'max_replicas,boundary_threshold,replica_overflow' "
        "triples; default is the frontier grid",
    )
    args = ap.parse_args()

    from spfresh_tpu.eval import recall_at_k
    from spfresh_tpu.index import Config, SpannIndexBuilder, brute_force_search

    n, nq = args.n, args.nq
    rng = np.random.default_rng(_SEED)
    n_centers = max(64, n // 1000)
    centers = rng.standard_normal((n_centers, args.dim)).astype(np.float32)

    def draw(m):
        a = rng.integers(0, n_centers, size=m)
        return (centers[a] + args.spread * rng.standard_normal((m, args.dim))).astype(
            np.float32
        )

    data = draw(n)
    queries = draw(nq)

    gt_key = (
        f"gt_n{n}_d{args.dim}_nq{nq}_k{args.k}_Euclidean"
        f"_s{args.spread}_latNone_seed{_SEED}_v1"
    )
    gt_path = os.path.join("/tmp/spann_bench_gt", gt_key + ".npz")
    if os.path.exists(gt_path):
        gt_i = np.load(gt_path)["gt_i"]
        log(f"ground truth: cached ({gt_path})")
    else:
        t0 = time.perf_counter()
        gt_d, gt_i = brute_force_search(data, queries, args.k, metric="Euclidean")
        log(f"ground truth: {time.perf_counter() - t0:.1f}s")
        os.makedirs(os.path.dirname(gt_path), exist_ok=True)
        np.savez(gt_path, gt_d=gt_d, gt_i=gt_i)

    if args.grid:
        grid = [
            tuple(float(x) for x in part.split(","))
            for part in args.grid.split(";")
            if part.strip()
        ]
        grid = [(int(mr), bt, ov) for mr, bt, ov in grid]
    else:
        # The frontier grid: the replica cap sets the ceiling, the boundary
        # sets admission, the overflow bounds fat postings.  bt=1.0 is the
        # no-closure floor (still a few replicas: medoid drift can put a
        # non-base centroid strictly nearer).
        grid = [
            (mr, bt, 1.25)
            for mr, bt in itertools.product((2, 4, 8), (1.0, 1.05, 1.10, 1.20))
        ] + [(8, 1.10, 1.0), (8, 1.10, 1.5)]

    rows = []
    for max_rep, bt, ov in grid:
        cfg = Config.from_dict(
            {
                "clustering_params": {
                    "distance_metric": "Euclidean",
                    "initialization_method": "KMeans++",
                    "initial_k": 16,
                    "desired_cluster_size": args.cluster_size,
                    "rng_seed": 42,
                    "max_replicas": max_rep,
                    "boundary_threshold": bt,
                    "replica_overflow": ov,
                },
                "output_path": "/tmp/spann_sweep_idx",
                "storage_dtype": args.storage_dtype,
                "search": {"query_batch_size": 4096},
            }
        )
        t0 = time.perf_counter()
        index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
        view = index.padded_view()
        jax.block_until_ready((view.vectors3d, view.ids2d))
        build_s = time.perf_counter() - t0
        stored_x = index.num_vectors / n

        best = last = None
        for nprobe in (2, 4, 8, 16, 24, 32, 48, 64, 96, 128):
            if nprobe > index.num_clusters:
                break
            ids, _ = index.search(queries, args.k, nprobe=nprobe)  # warm
            dt = min(
                _t(lambda: index.search(queries, args.k, nprobe=nprobe))
                for _ in range(3)
            )
            rec = recall_at_k(ids, gt_i, args.k)
            last = (nprobe, rec, nq / dt)
            if rec >= args.target_recall:
                best = last
                break
        nprobe, rec, qps = best or last
        row = {
            "max_replicas": max_rep,
            "boundary_threshold": bt,
            "replica_overflow": ov,
            "stored_x": round(stored_x, 3),
            "pad": int(view.pad),
            "clusters": int(index.num_clusters),
            "nprobe": nprobe,
            "recall": round(float(rec), 4),
            "qps": round(qps, 0),
            "build_s": round(build_s, 1),
            "hit_target": best is not None,
        }
        rows.append(row)
        log(
            f"max_rep={max_rep} bt={bt:.2f} ov={ov:.2f}  "
            f"stored_x={stored_x:.2f} pad={view.pad:4d}  "
            f"nprobe={nprobe:3d} recall={rec:.4f} qps={qps:7,.0f}  "
            f"build={build_s:.1f}s{'' if best else '  (below target)'}"
        )
        # Free the device view before the next config's build.
        index.drop_device_views()
        del index, view

    print(json.dumps({"n": n, "dim": args.dim, "spread": args.spread, "rows": rows}))


def _t(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


if __name__ == "__main__":
    main()
