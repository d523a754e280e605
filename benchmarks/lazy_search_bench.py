"""Disk-backed lazy search: pipelined vs synchronous staging (VERDICT r1 #7).

Measures `LazySpannIndex` (HBM holds centroids only; postings mmap'd from
the packed CSR on disk) at corpus sizes where the resident mode would not
fit, comparing `prefetch_threads=0` (stage batch i, then rerank batch i —
serialized) against the software pipeline (batch i+1 stages on a background
thread — native C++ when built — while batch i uploads + reranks).

The index is synthesized straight into the packed on-disk layout — lazy
search never reads anything the build would have added, so this measures
exactly the steady-state query path.

Run:  python benchmarks/lazy_search_bench.py --n 5000000
"""

import argparse
import gzip
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spfresh_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

from spfresh_tpu.index.lazy import LazySpannIndex
from spfresh_tpu.index.posting_store import write_packed_postings
from spfresh_tpu.index.spann import CENTROIDS_FILE, MANIFEST


def synthesize(directory: str, n: int, dim: int, cluster_size: int, seed: int):
    rng = np.random.default_rng(seed)
    C = max(1, n // cluster_size)
    cents = rng.standard_normal((C, dim)).astype(np.float32)
    sizes = np.full(C, n // C, np.int64)
    sizes[: n - int(sizes.sum())] += 1
    offsets = np.zeros(C + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    ids = np.arange(n, dtype=np.int64)
    vectors = np.empty((n, dim), np.float32)
    for c in range(C):  # chunked generation bounds peak RNG scratch
        s, e = offsets[c], offsets[c + 1]
        vectors[s:e] = cents[c] + 0.3 * rng.standard_normal((e - s, dim))
    write_packed_postings(
        os.path.join(directory, "postings.csr"), np.arange(C), offsets, ids, vectors
    )
    with gzip.open(os.path.join(directory, CENTROIDS_FILE), "wb") as f:
        np.save(f, cents)
    with open(os.path.join(directory, MANIFEST), "w") as f:
        json.dump({
            "format_version": 1, "layout": "packed", "dim": dim,
            "num_clusters": C, "cluster_ids": list(range(C)),
            "next_cluster_id": C, "config": {},
        }, f)
    queries = cents[rng.integers(0, C, 512)] + 0.3 * rng.standard_normal((512, dim))
    return C, queries.astype(np.float32)


def run(directory: str, queries, k, nprobe, batch, threads, storage="float32"):
    from spfresh_tpu.index.config import Config

    cfg = Config.from_dict({"storage_dtype": storage})
    with LazySpannIndex(directory, config=cfg, prefetch_threads=threads) as idx:
        idx.search(queries[:batch], k=k, nprobe=nprobe, batch_size=batch)  # warm
        t0 = time.perf_counter()
        ids, _ = idx.search(queries, k=k, nprobe=nprobe, batch_size=batch)
        dt = time.perf_counter() - t0
        native = idx._native is not None
    return len(queries) / dt, ids, native


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=5_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--cluster-size", type=int, default=1000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--storage-dtype", default="bfloat16",
                    help="wire/compute dtype for the staged slabs")
    ap.add_argument("--dir", default=None, help="reuse a synthesized index dir")
    args = ap.parse_args()

    d = args.dir or tempfile.mkdtemp(prefix="lazy_bench_")
    os.makedirs(d, exist_ok=True)
    if not os.path.exists(os.path.join(d, "postings.csr")):
        t0 = time.perf_counter()
        C, queries = synthesize(d, args.n, args.dim, args.cluster_size, 0)
        print(f"synthesized {args.n}x{args.dim} ({C} clusters) -> {d} "
              f"in {time.perf_counter()-t0:.1f}s")
        np.save(os.path.join(d, "queries.npy"), queries)
    queries = np.load(os.path.join(d, "queries.npy"))

    qps_sync, ids_sync, _ = run(
        d, queries, args.k, args.nprobe, args.batch, 0, args.storage_dtype)
    qps_pipe, ids_pipe, native = run(
        d, queries, args.k, args.nprobe, args.batch, 2, args.storage_dtype)
    assert np.array_equal(ids_sync, ids_pipe), "pipeline changed results"
    print(f"lazy search ({'native' if native else 'python'} staging, "
          f"{args.storage_dtype} wire), "
          f"n={args.n} nprobe={args.nprobe} batch={args.batch}:")
    print(f"  synchronous staging: {qps_sync:8.1f} q/s")
    print(f"  pipelined  staging : {qps_pipe:8.1f} q/s   "
          f"({qps_pipe / qps_sync:.2f}x)")


if __name__ == "__main__":
    main()
