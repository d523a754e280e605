"""DEEP-100M BUILD proof — the out-of-core build machinery at true 100M scale.

The BUILD half of the 100M claim (the SERVE half is deep100m_serve.py):
run the REAL `fit_outofcore` pipeline — sample fit, streamed base assign,
host rebalance, streamed replica pass, assembly, streaming packed save —
on a 100M-row corpus that lives only on disk, then prove the result serves.

Unlike the serve harness (which synthesizes a valid index directly), this
one hands the builder a raw shuffled corpus and makes the build DISCOVER
the structure: rows are a mixture of `--components` tight Gaussians in
row-hash order (no cluster locality), so every pass sees the worst-case
streaming pattern.

CPU-sized by default (reduced dim + coarse cap bound the n*C*d FLOPs of
the two streamed passes); on the card it runs the full-fat shape.  Checks:

  1. the build completes with peak host RSS far below corpus-in-RAM-twice,
  2. every cluster respects the cap * replica_overflow budget,
  3. the saved packed index opens lazily and self-queries return their own
     row top-1 (ids/offsets are int64-correct past 2^31 bytes),
  4. per-phase wall profile recorded.

Prints ONE JSON line.  Run:   python benchmarks/deep100m_build.py
Smoke:  python benchmarks/deep100m_build.py --rows 2000000 --cap 20000
"""

import argparse
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


def synthesize_corpus(path: str, n: int, dim: int, components: int):
    """Stream a shuffled mixture-of-Gaussians corpus to an f32 memmap.
    Component centers are unit Gaussians (pairwise separation ~sqrt(2*dim)
    dwarfs the 0.05-sigma spread), and each row's component is an iid draw —
    NO cluster locality in row order, so the streamed passes can't cheat."""
    rng = np.random.default_rng(_SEED)
    cents = rng.standard_normal((components, dim)).astype(np.float32)
    mm = np.lib.format.open_memmap(
        path, mode="w+", dtype=np.float32, shape=(n, dim)
    )
    probes = []
    t0 = time.perf_counter()
    block = 4_000_000
    for s in range(0, n, block):
        e = min(s + block, n)
        comp = rng.integers(0, components, size=e - s)
        mm[s:e] = cents[comp] + 0.05 * rng.standard_normal(
            (e - s, dim)
        ).astype(np.float32)
        if s == 0 or e == n or (s <= n // 2 < e):
            j = 0 if s == 0 else (n // 2 - s if s <= n // 2 < e else e - 1 - s)
            probes.append((int(s + j), mm[s + j].copy()))
    mm.flush()
    log(f"corpus: {n:,} x {dim}-d mixture({components}) in "
        f"{time.perf_counter()-t0:.0f}s ({os.path.getsize(path)/2**30:.1f} GiB)")
    return probes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--components", type=int, default=4096)
    ap.add_argument("--cap", type=int, default=400_000,
                    help="desired_cluster_size -> C ~= rows/cap")
    ap.add_argument("--sample-rows", type=int, default=2_000_000)
    ap.add_argument("--tile-rows", type=int, default=262_144)
    ap.add_argument("--initial-k", type=int, default=16)
    ap.add_argument("--max-replicas", type=int, default=4)
    ap.add_argument("--workdir", default="/root/deep100m_build")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()

    os.makedirs(args.workdir, exist_ok=True)
    corpus_path = os.path.join(args.workdir, "corpus.npy")
    probes = synthesize_corpus(corpus_path, args.rows, args.dim,
                               args.components)
    gen_rss = rss_gib()

    from spfresh_tpu.index import Config, LazySpannIndex, SpannIndexBuilder

    out_path = os.path.join(args.workdir, "idx")
    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": args.initial_k,
                "desired_cluster_size": args.cap,
                "max_replicas": args.max_replicas,
                "rng_seed": _SEED,
            },
            "build_sample_rows": args.sample_rows,
            "build_tile_rows": args.tile_rows,
            "output_path": out_path,
        }
    )
    corpus = np.load(corpus_path, mmap_mode="r")
    t0 = time.perf_counter()
    index = SpannIndexBuilder(cfg).with_data(corpus).build(save=False)
    build_s = time.perf_counter() - t0
    profile = dict(index.build_profile)
    sizes = np.array([len(index.postings[c][0]) for c in index.postings])
    budget = int(np.ceil(1.25 * args.cap))  # replica_overflow default
    log(f"build: {build_s:.0f}s, C={len(sizes)}, sizes "
        f"min/med/max = {sizes.min()}/{int(np.median(sizes))}/{sizes.max()}, "
        f"stored x{sizes.sum()/args.rows:.2f}, rss {rss_gib():.1f} GiB")
    t0 = time.perf_counter()
    index.save(out_path)
    save_s = time.perf_counter() - t0
    build_rss = rss_gib()
    del index

    # Serve the artifact: self-queries must return their own row top-1.
    t0 = time.perf_counter()
    lazy = LazySpannIndex(out_path)
    q = np.stack([v for _, v in probes])
    expect = np.array([i for i, _ in probes], np.int64)
    ids1, d1 = lazy.search(q, 10, nprobe=4)
    serve_s = time.perf_counter() - t0
    self_hit = bool(np.array_equal(ids1[:, 0], expect))
    log(f"serve: top1={ids1[:, 0].tolist()} expect={expect.tolist()} "
        f"hit={self_hit} in {serve_s:.0f}s")
    lazy.close()

    out = {
        "n": args.rows,
        "dim": args.dim,
        "C": int(len(sizes)),
        "cap": args.cap,
        "stored_x": round(float(sizes.sum()) / args.rows, 3),
        "max_cluster_within_budget": bool(sizes.max() <= budget),
        "build_s": round(build_s, 1),
        "save_s": round(save_s, 1),
        "phase_profile_s": {k: round(v, 1) for k, v in profile.items()},
        "self_query_top1_exact": self_hit,
        "serve_s": round(serve_s, 1),
        "gen_rss_gib": round(gen_rss, 2),
        "peak_rss_gib": round(build_rss, 2),
        "packed_gib": round(
            os.path.getsize(os.path.join(out_path, "postings.csr")) / 2**30,
            1,
        ),
    }
    print(json.dumps(out))
    ok = self_hit and sizes.max() <= budget
    if not args.keep:
        import shutil

        shutil.rmtree(args.workdir, ignore_errors=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
