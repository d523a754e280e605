"""Out-of-core build at DEEP scale: corpus on disk, one chip, bounded HBM.

BASELINE config 5 asks for DEEP-100M-shape host-offloaded serving; the
reference cannot even BUILD at that scale (its builder materializes the
corpus in memory, spann_builder.rs:25-64) and neither can an in-core device
build (38 GB corpus vs 16 GB HBM).  This harness:

1. writes an n x dim f32 corpus to disk as a memmap (chunked generation),
2. builds the index OUT-OF-CORE via the public facade
   (``Config.build_sample_rows``): sample fit in HBM, two streamed passes
   over the memmap, bf16 wire,
3. saves the packed layout, opens it with ``LazySpannIndex`` (HBM holds
   centroids only), and measures recall@10 / QPS against a streamed exact
   GT over the full corpus.

Prints one JSON line with the build decomposition (wall / link / device),
per-phase profile, and the search operating points.

Run:  python benchmarks/outofcore_build_bench.py --n 20000000
      python benchmarks/outofcore_build_bench.py --n 100000000   # DEEP-100M shape
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from spfresh_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

_SEED = 12345


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def gen_corpus(path: str, n: int, dim: int, spread: float, seed: int):
    """Chunked mixture-of-Gaussians corpus straight to a disk memmap."""
    rng = np.random.default_rng(seed)
    n_centers = max(64, min(n // 1000, 65536))
    centers = rng.standard_normal((n_centers, dim)).astype(np.float32)
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=(n, dim))
    CH = 1 << 20
    for s in range(0, n, CH):
        e = min(s + CH, n)
        a = rng.integers(0, n_centers, e - s)
        mm[s:e] = centers[a] + spread * rng.standard_normal(
            (e - s, dim)
        ).astype(np.float32)
    mm.flush()
    return centers


def streamed_gt(data, queries, k: int, tile: int = 1 << 18):
    """Exact top-k via streamed device tiles (the corpus never uploads
    whole): per tile, (nq, tile) distances + fold into the running best."""
    from spfresh_tpu.ops.distances import pairwise_distance
    from spfresh_tpu.ops.topk import smallest_k

    n = data.shape[0]
    q = jnp.asarray(queries, jnp.float32)

    @jax.jit
    def fold(best_d, best_i, block, start, n_total):
        D = pairwise_distance(q, block, "Euclidean")
        col = start + jax.lax.broadcasted_iota(jnp.int32, D.shape, 1)
        D = jnp.where(col < n_total, D, jnp.inf)  # mask padding rows
        cat_d = jnp.concatenate([best_d, D], axis=1)
        cat_i = jnp.concatenate([best_i, col], axis=1)
        vals, idx = smallest_k(cat_d, k)
        return vals, jnp.take_along_axis(cat_i, idx, axis=1)

    best_d = jnp.full((len(queries), k), jnp.inf)
    best_i = jnp.zeros((len(queries), k), jnp.int32)
    for s in range(0, n, tile):
        e = min(s + tile, n)
        block = np.zeros((tile, data.shape[1]), np.float32)
        block[: e - s] = data[s:e]
        best_d, best_i = fold(
            best_d, best_i, jnp.asarray(block), jnp.int32(s), jnp.int32(n)
        )
    return np.asarray(best_d), np.asarray(best_i)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000_000)
    ap.add_argument("--dim", type=int, default=96)
    ap.add_argument("--sample", type=int, default=1_000_000)
    ap.add_argument("--tile", type=int, default=262_144)
    ap.add_argument("--cluster-size", type=int, default=256)
    ap.add_argument("--nq", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--spread", type=float, default=0.7)
    ap.add_argument("--storage-dtype", default="bfloat16")
    ap.add_argument("--workdir", default="/tmp/oc_deep")
    ap.add_argument("--keep", action="store_true", help="keep corpus+index files")
    args = ap.parse_args()

    from spfresh_tpu.eval import recall_at_k
    from spfresh_tpu.index import Config, LazySpannIndex, SpannIndexBuilder
    from spfresh_tpu.utils.xfer import STATS

    os.makedirs(args.workdir, exist_ok=True)
    corpus_path = os.path.join(args.workdir, "corpus.f32")
    n, d = args.n, args.dim

    need = n * d * 4
    if not (
        os.path.exists(corpus_path)
        and os.path.getsize(corpus_path) == need
    ):
        t0 = time.perf_counter()
        centers = gen_corpus(corpus_path, n, d, args.spread, _SEED)
        log(f"corpus: {need / 2**30:.1f} GiB written in "
            f"{time.perf_counter() - t0:.0f}s")
    data = np.memmap(corpus_path, dtype=np.float32, mode="r", shape=(n, d))

    rng = np.random.default_rng(_SEED + 1)
    qrows = rng.choice(n, size=args.nq, replace=False)
    queries = np.asarray(data[np.sort(qrows)]) + 0.1 * rng.standard_normal(
        (args.nq, d)
    ).astype(np.float32)

    cfg = Config.from_dict(
        {
            "clustering_params": {
                "distance_metric": "Euclidean",
                "initialization_method": "KMeans++",
                "initial_k": 16,
                "desired_cluster_size": args.cluster_size,
                "rng_seed": 42,
            },
            "output_path": os.path.join(args.workdir, "index"),
            "storage_dtype": args.storage_dtype,
            "build_sample_rows": args.sample,
            "build_tile_rows": args.tile,
            "search": {"query_batch_size": max(256, args.nq)},
        }
    )
    STATS.reset()
    t0 = time.perf_counter()
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    build_wall = time.perf_counter() - t0
    xfer = STATS.as_dict()
    build_xfer = STATS.total_s
    profile = dict(index.build_profile)
    log(
        f"build: wall={build_wall:.1f}s = link {build_xfer:.1f}s "
        f"({xfer['h2d_mb']:.0f} MB h2d) + device/host "
        f"{build_wall - build_xfer:.1f}s; clusters={index.num_clusters} "
        f"stored={index.num_vectors} (x{index.num_vectors / n:.2f})"
    )
    for name, tot in sorted(profile.items(), key=lambda kv: -kv[1]):
        log(f"  phase {name:28s} {tot:8.2f}s")

    num_clusters, stored = index.num_clusters, index.num_vectors
    t0 = time.perf_counter()
    index.save(cfg.output_path)
    save_s = time.perf_counter() - t0
    log(f"save (packed): {save_s:.1f}s")
    index.drop_device_views()
    del index

    # GT over the full corpus, streamed (cacheable across reruns).
    gt_path = os.path.join(
        args.workdir, f"gt_n{n}_d{d}_nq{args.nq}_k{args.k}.npz"
    )
    if os.path.exists(gt_path):
        gt_i = np.load(gt_path)["gt_i"]
        log("ground truth: cached")
    else:
        t0 = time.perf_counter()
        _, gt_i = streamed_gt(data, queries, args.k)
        log(f"ground truth (streamed): {time.perf_counter() - t0:.1f}s")
        np.savez(gt_path, gt_i=gt_i)

    lazy = LazySpannIndex(cfg.output_path, cfg)
    log(f"lazy open: {lazy.num_clusters} lists, pad {lazy.pad}")
    rows = []
    for nprobe in (4, 8, 16, 32):
        ids, _ = lazy.search(queries, args.k, nprobe=nprobe)  # warm
        t0 = time.perf_counter()
        ids, _ = lazy.search(queries, args.k, nprobe=nprobe)
        dt = time.perf_counter() - t0
        rec = recall_at_k(ids, gt_i, args.k)
        rows.append(
            {
                "nprobe": nprobe,
                "recall": round(float(rec), 4),
                "qps": round(args.nq / dt, 1),
            }
        )
        log(f"nprobe={nprobe:3d} recall@{args.k}={rec:.4f} "
            f"qps={args.nq / dt:,.0f}")
        if rec >= 0.95:
            break
    import resource

    # Peak host RSS (the DEEP-100M claim is "100M needs only disk": the
    # figure proves the build+serve never materialized the corpus in RAM).
    peak_rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20

    print(
        json.dumps(
            {
                "n": n,
                "peak_rss_gib": round(peak_rss_gib, 2),
                "dim": d,
                "sample_rows": args.sample,
                "corpus_gib": round(need / 2**30, 1),
                "build_wall_s": round(build_wall, 1),
                "build_xfer_s": round(build_xfer, 1),
                "build_device_s": round(build_wall - build_xfer, 1),
                "build_xfer": xfer,
                "build_phases": {
                    k2: round(v, 2) for k2, v in profile.items()
                },
                "save_s": round(save_s, 1),
                "clusters": num_clusters,
                "stored_x": round(stored / n, 2),
                "search": rows,
            }
        )
    )
    if not args.keep:
        for f in (corpus_path,):
            try:
                os.remove(f)
            except OSError:
                pass


if __name__ == "__main__":
    main()
