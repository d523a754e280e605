"""DEEP-100M SERVE proof (CPU-capable).

This proves the 100M-scale claim ("100M needs only disk"), including the
int32/int64 slot+id guards at that scale and a peak-RAM figure.  The full out-of-core BUILD at 100M is accelerator-bound
(streamed assign is ~1e17 FLOPs); the SERVE
machinery, however, can be proven anywhere: this harness synthesizes a
VALID 100M-row packed index directly (members drawn around well-separated
centroids, written in cluster order through the streaming CSR writer — no
clustering needed), then drives the real serving + live-update stack on
it:

  1. `LazySpannIndex` open + self-queries (top-1 must be the queried row:
     the vector region alone spans ~12.8 GB, so every mmap/native-reader
     byte offset past 2^31 is exercised; ids are int64 end-to-end),
  2. `LazySpFreshIndex` live inserts + deletes + WAL flush + reopen at a
     100M-row base (version space starts past 1e8; reverse-id lookups
     binary-search the mmap'd id column),
  3. peak host RSS recorded (the corpus never materializes in RAM).

Prints ONE JSON line.  Run:  python benchmarks/deep100m_serve.py
Smoke:  python benchmarks/deep100m_serve.py --clusters 2000
"""

import argparse
import gzip
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spfresh_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

_SEED = 20260818


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def synthesize(workdir: str, n_clusters: int, per: int, dim: int):
    """Write a valid packed-layout index of n_clusters * per rows: members
    of cluster c are c's centroid + 0.1-sigma noise (centroids are unit
    Gaussians — at 32-d their pairwise distances dwarf the spread, so the
    nearest centroid of any member is its own cluster).  Streams in
    ~256-cluster blocks; peak RAM is one block + the int64 id column."""
    from spfresh_tpu.index.posting_store import write_packed_postings_streaming
    from spfresh_tpu.index.spann import CENTROIDS_FILE, MANIFEST, PACKED_FILE

    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(_SEED)
    C, n = n_clusters, n_clusters * per
    cents = rng.standard_normal((C, dim)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64)
    offsets = np.arange(C + 1, dtype=np.int64) * per
    probes = []  # (row_id, vector) kept for self-queries

    def blocks():
        CH = 256
        for c0 in range(0, C, CH):
            c1 = min(c0 + CH, C)
            m = (c1 - c0) * per
            blk = (
                np.repeat(cents[c0:c1], per, axis=0)
                + 0.1 * rng.standard_normal((m, dim)).astype(np.float32)
            )
            if c0 == 0 or c1 == C or (c0 <= C // 2 < c1):
                j = 0 if c0 == 0 else (C // 2 - c0 if c0 <= C // 2 < c1 else c1 - 1 - c0)
                row = j * per
                probes.append((int(c0 * per + row), blk[row].copy()))
            yield blk.astype(np.float32)

    t0 = time.perf_counter()
    write_packed_postings_streaming(
        os.path.join(workdir, PACKED_FILE), ids[:C].tolist(), offsets, ids,
        blocks(), dim,
    )
    with gzip.open(os.path.join(workdir, CENTROIDS_FILE), "wb") as f:
        np.save(f, cents)
    manifest = {
        "format_version": 1,
        "layout": "packed",
        "dim": dim,
        "num_clusters": C,
        "cluster_ids": list(range(C)),
        "next_cluster_id": C,
        "config": {
            "clustering_params": {"rng_seed": _SEED},
            "storage_dtype": "bfloat16",
            "output_path": workdir,
        },
    }
    with open(os.path.join(workdir, MANIFEST), "w") as f:
        json.dump(manifest, f)
    log(f"synthesized {n:,} rows x {dim}-d in {time.perf_counter()-t0:.0f}s "
        f"({os.path.getsize(os.path.join(workdir, PACKED_FILE))/2**30:.1f} GiB)")
    return probes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clusters", type=int, default=97_657)
    ap.add_argument("--per", type=int, default=1024)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--workdir", default="/root/deep100m")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()
    n = args.clusters * args.per

    probes = synthesize(args.workdir, args.clusters, args.per, args.dim)
    gen_rss = rss_gib()

    from spfresh_tpu.index import LazySpannIndex
    from spfresh_tpu.lire import LireConfig
    from spfresh_tpu.lire.lazy_fresh import LazySpFreshIndex

    # 1. Read-only serve: every self-query's top-1 must be its own row.
    t0 = time.perf_counter()
    lazy = LazySpannIndex(args.workdir)
    open_s = time.perf_counter() - t0
    log(f"lazy open: {lazy.num_clusters:,} lists, pad {lazy.pad}, "
        f"max_dup {lazy.max_dup} in {open_s:.0f}s")
    q = np.stack([v for _, v in probes])
    expect = np.array([i for i, _ in probes], np.int64)
    t0 = time.perf_counter()
    ids1, d1 = lazy.search(q, 10, nprobe=4)
    search_s = time.perf_counter() - t0
    self_hit = bool(np.array_equal(ids1[:, 0], expect))
    log(f"self-queries: top1={ids1[:, 0].tolist()} expect={expect.tolist()} "
        f"hit={self_hit} maxd={float(d1[:, 0].max()):.4f}")
    lazy.close()

    # 2. Live updates on the 100M base (versions start past n).
    t0 = time.perf_counter()
    with LazySpFreshIndex(
        args.workdir, lire_config=LireConfig(max_partition_size=args.per * 4)
    ) as fresh:
        rng = np.random.default_rng(1)
        new_ids = np.arange(n + 1000, n + 1100, dtype=np.int64)
        vecs = q[0][None, :] + 0.01 * rng.standard_normal(
            (len(new_ids), args.dim)
        ).astype(np.float32)
        fresh.insert_batch(vecs, new_ids)
        ids2, _ = fresh.search(vecs[:4], 1, nprobe=4)
        insert_ok = bool(np.all(np.isin(ids2[:, 0], new_ids)))
        fresh.delete(int(new_ids[0]))
        ids3, _ = fresh.search(vecs[:1], 5, nprobe=4)
        delete_ok = bool(int(new_ids[0]) not in ids3[0])
        fresh.storage.flush()
        ver = fresh.storage.current_version()
    update_s = time.perf_counter() - t0
    # 3. Reopen: WAL replays over the 100M base.
    with LazySpFreshIndex(args.workdir) as fresh2:
        ids4, _ = fresh2.search(vecs[1:2], 1, nprobe=4)
        reopen_ok = bool(ids4[0, 0] == new_ids[1])

    out = {
        "n": n,
        "dim": args.dim,
        "clusters": args.clusters,
        "packed_gib": round(n * args.dim * 4 / 2**30, 1),
        "open_s": round(open_s, 1),
        "self_query_top1_exact": self_hit,
        "search_s": round(search_s, 2),
        "insert_searchable": insert_ok,
        "delete_effective": delete_ok,
        "wal_reopen_serves_inserts": reopen_ok,
        "version_past_base_rows": ver > n,
        "peak_rss_gib": round(rss_gib(), 2),
        "gen_rss_gib": round(gen_rss, 2),
    }
    print(json.dumps(out))
    ok = all([self_hit, insert_ok, delete_ok, reopen_ok, ver > n])
    if not args.keep:
        import shutil

        shutil.rmtree(args.workdir, ignore_errors=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
