"""Disk-backed SPFresh streaming updates (BASELINE.md config 5, SSD-tier
shape): build once, save the packed layout, then stream interleaved
inserts/deletes through ``LazySpFreshIndex`` — the corpus stays on disk,
HBM holds only the centroid routing tier, host RAM only the delta
overlay.  Measures update throughput, search-visible throughput (the
overlay patch rides every staged batch), recall drift, and compaction.

Usage:
    python benchmarks/disk_updates_bench.py [--n 200000] [--updates 20000]
"""

import argparse
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spfresh_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--dim", type=int, default=96)
    ap.add_argument("--updates", type=int, default=20_000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--dir", default="/tmp/spfresh_disk_bench_idx")
    ap.add_argument("--reuse", action="store_true",
                    help="reuse an existing index dir (skip the build)")
    args = ap.parse_args()

    from spfresh_tpu.eval import recall_at_k
    from spfresh_tpu.index import Config, SpannIndexBuilder, brute_force_search
    from spfresh_tpu.lire import LazySpFreshIndex, LireConfig

    rng = np.random.default_rng(7)
    n_centers = max(32, args.n // 1000)
    centers = rng.standard_normal((n_centers, args.dim)).astype(np.float32)

    def draw(m):
        a = rng.integers(0, n_centers, size=m)
        return (centers[a] + 0.35 * rng.standard_normal((m, args.dim))).astype(np.float32)

    data = draw(args.n)
    if not args.reuse:
        cfg = Config.from_dict(
            {
                "clustering_params": {
                    "initialization_method": "KMeans++",
                    "initial_k": 16,
                    "desired_cluster_size": 512,
                    "rng_seed": 42,
                },
            }
        )
        t0 = time.perf_counter()
        index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
        shutil.rmtree(args.dir, ignore_errors=True)
        index.save(args.dir, format="packed")
        print(
            f"build+save: {time.perf_counter() - t0:.1f}s "
            f"clusters={index.num_clusters}",
            flush=True,
        )
        del index

    lire_cfg = LireConfig(max_partition_size=1024, min_partition_size=16)
    with LazySpFreshIndex(args.dir, lire_config=lire_cfg) as fresh:
        queries = draw(200)
        _, gt0 = brute_force_search(data, queries, 10)
        ids0, _ = fresh.search(queries, 10, nprobe=16)
        print(f"recall before updates: {recall_at_k(ids0, gt0, 10):.4f}", flush=True)

        # Warm routing + staging compiles out of the timed sections.
        warm_ids = np.arange(9_000_000, 9_000_032)
        fresh.insert_batch(draw(32), warm_ids)
        fresh.search(queries[:8], 10, nprobe=8)
        fresh.delete_batch(warm_ids)
        fresh.search(queries[:8], 10, nprobe=8)

        new_vecs = draw(args.updates)
        new_ids = np.arange(args.n, args.n + args.updates)
        t0 = time.perf_counter()
        for s in range(0, args.updates, args.batch):
            fresh.insert_batch(new_vecs[s : s + args.batch], new_ids[s : s + args.batch])
        insert_s = time.perf_counter() - t0
        print(f"inserts: {args.updates / insert_s:,.0f}/s ({insert_s:.1f}s)", flush=True)

        # Search-visible throughput: the overlay patch must reach every
        # probed slab before the next batch (SPFresh freshness contract).
        more_vecs = draw(args.updates)
        more_ids = np.arange(args.n + args.updates, args.n + 2 * args.updates)
        probe = queries[:8]
        t0 = time.perf_counter()
        for s in range(0, args.updates, args.batch):
            fresh.insert_batch(more_vecs[s : s + args.batch], more_ids[s : s + args.batch])
            fresh.search(probe, 10, nprobe=8)
        visible_s = time.perf_counter() - t0
        print(
            f"insert+visible: {args.updates / visible_s:,.0f}/s ({visible_s:.1f}s, "
            f"search refresh per {args.batch}-batch)",
            flush=True,
        )

        del_ids = rng.choice(args.n, size=args.updates // 2, replace=False)
        t0 = time.perf_counter()
        deleted = 0
        for s in range(0, len(del_ids), args.batch):
            deleted += fresh.delete_batch(del_ids[s : s + args.batch])
        delete_s = time.perf_counter() - t0
        print(f"deletes: {deleted / delete_s:,.0f}/s ({delete_s:.1f}s)", flush=True)

        t0 = time.perf_counter()
        fresh.flush()
        print(f"background drain: {time.perf_counter() - t0:.1f}s", flush=True)

        live_mask = np.ones(args.n, bool)
        live_mask[del_ids] = False
        all_data = np.concatenate([data[live_mask], new_vecs, more_vecs])
        all_ids = np.concatenate([np.arange(args.n)[live_mask], new_ids, more_ids])
        _, gt_rows = brute_force_search(all_data, queries, 10)
        gt = all_ids[gt_rows]
        ids1, _ = fresh.search(queries, 10, nprobe=16)
        print(f"recall after updates: {recall_at_k(ids1, gt, 10):.4f}", flush=True)
        print(f"overlay rows: {fresh.storage.overlay_rows():,} "
              f"(clusters {fresh.num_clusters})", flush=True)

        t0 = time.perf_counter()
        fresh.compact()
        print(f"compaction: {time.perf_counter() - t0:.1f}s", flush=True)
        ids2, _ = fresh.search(queries, 10, nprobe=16)
        print(f"recall after compaction: {recall_at_k(ids2, gt, 10):.4f}", flush=True)


if __name__ == "__main__":
    main()
