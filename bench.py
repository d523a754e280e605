"""Headline benchmark: QPS at recall@10 >= 0.90 on SIFT1M-scale data, on
one NVIDIA GPU.

Prints exactly ONE JSON line on stdout:
    {"metric": ..., "value": N, "unit": "qps", "vs_baseline": N, ...}
(``vs_baseline`` is QPS / 10,000 scaled by any recall shortfall.)  The run
fails when JAX finds no GPU.

Data: a seeded Gaussian mixture at 128-d (``spfresh_tpu.eval.
mixture_corpus``) with exact on-device ground truth.  Build config follows
BASELINE.md config 3 (nprobe sweep to the 0.90 recall point).

Side metrics (build time, recall, sweep points) go to stderr, each line
with the card's name and power limit.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from spfresh_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


_BENCH_SEED = 12345  # corpus seed


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="smoke test scale")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--nq", type=int, default=16384)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--cluster-size", type=int, default=256)
    ap.add_argument("--initial-k", type=int, default=16)
    ap.add_argument("--target-recall", type=float, default=0.90)
    ap.add_argument("--batch", type=int, default=8192,
                    help="query batch per dispatch")
    ap.add_argument("--storage-dtype", default="bfloat16",
                    help="bfloat16 (default: half the device footprint and "
                         "slab bytes) | float32 | int8 (residual IVF-SQ8: "
                         "quarter-of-f32 slabs, per-posting scales)")
    ap.add_argument("--metric", default="Euclidean",
                    help="Euclidean | Manhattan | Chebyshev (GIST-style "
                         "stress: --metric Manhattan --dim 960)")
    ap.add_argument("--spread", type=float, default=0.7,
                    help="cluster radius / unit center scale — the corpus "
                         "difficulty knob (hardness is logged per run). "
                         "0.35 = well-separated clusters; 0.7 (default) = "
                         "moderate overlap; 1.0 = heavy overlap")
    ap.add_argument("--mesh", default=None,
                    help="build over a device mesh: 'auto' (all local devices "
                         "when >1 real accelerator), an integer device count, "
                         "or omit for the single-device build.  Results are "
                         "bit-identical to the single-device path (tested)")
    ap.add_argument("--max-split-ways", type=int, default=None,
                    help="children per subdivision round (default: Config's)")
    ap.add_argument("--max-replicas", type=int, default=None,
                    help="closure-replica cap per point (default: Config's)")
    ap.add_argument("--boundary-threshold", type=float, default=None,
                    help="replica admission d(p,c_j) < bt * d(p,c_base) "
                         "(default: Config's)")
    ap.add_argument("--soar-lambda", type=float, default=None,
                    help="SOAR replica ranking weight (Euclidean only; "
                         "default: Config's auto).  Pass 0 for the "
                         "reference's plain distance ranking")
    ap.add_argument("--replica-overflow", type=float, default=None,
                    help="posting replica headroom factor (default: Config's)")
    ap.add_argument("--query-wire", default="bfloat16",
                    choices=["float32", "bfloat16", "int8"],
                    help="dtype query batches are shipped to the device in "
                         "(upcast on device); float32 = exact wire")
    ap.add_argument("--latent-dim", type=int, default=None,
                    help="draw the corpus on an L-dimensional linear manifold "
                         "embedded in --dim (plus 1%% ambient noise), e.g. "
                         "--dim 960 --latent-dim 32 for a GIST-like corpus")
    args = ap.parse_args()

    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"bench: no GPU (JAX platform {devs[0].platform!r})")
        sys.exit(2)
    from spfresh_tpu.utils.card import card_name

    card = card_name()

    from spfresh_tpu.eval import mixture_corpus, recall_at_k
    from spfresh_tpu.index import Config, SpannIndexBuilder, brute_force_search

    n = args.n or (20_000 if args.small else 1_000_000)
    nq = min(args.nq, 200) if args.small else args.nq
    log(f"bench: n={n} dim={args.dim} nq={nq} device={devs[0].device_kind} "
        f"x{len(devs)} card=[{card}]")
    data, queries = mixture_corpus(n, nq, args.dim, seed=_BENCH_SEED,
                                   spread=args.spread,
                                   latent_dim=args.latent_dim)
    t0 = time.perf_counter()
    gt_d, gt_i = brute_force_search(data, queries, args.k, metric=args.metric)
    log(f"ground truth: {time.perf_counter() - t0:.1f}s")
    # Corpus-hardness diagnostics (comparable to published SIFT1M values):
    # local intrinsic dimensionality (Levina-Bickel MLE over the kNN radii;
    # SIFT1M ~10-13) — high LID = neighbors hard to separate locally.
    d_sqrt = np.sqrt(np.maximum(gt_d, 0)) + 1e-12
    lid = 1.0 / np.maximum(
        np.mean(np.log(d_sqrt[:, -1:] / d_sqrt[:, :-1]), axis=1), 1e-9
    )
    log(f"corpus hardness: LID(median)={np.median(lid):.1f} spread={args.spread}")

    rep_knobs = {
        k: v
        for k, v in (
            ("max_replicas", args.max_replicas),
            ("boundary_threshold", args.boundary_threshold),
            ("replica_overflow", args.replica_overflow),
            ("max_split_ways", args.max_split_ways),
            ("soar_lambda", args.soar_lambda),
        )
        if v is not None
    }
    cfg = Config.from_dict(
        {
            "clustering_params": {
                "distance_metric": args.metric,
                "initialization_method": "KMeans++",
                "initial_k": args.initial_k,
                "desired_cluster_size": args.cluster_size,
                "rng_seed": 42,
                **rep_knobs,
            },
            "storage_dtype": args.storage_dtype,
            "search": {"query_batch_size": args.batch,
                       "query_wire": args.query_wire},
        }
    )
    from spfresh_tpu.utils.xfer import STATS

    mesh = args.mesh
    if mesh is not None and mesh != "auto":
        mesh = int(mesh)
    builder = SpannIndexBuilder(cfg, mesh=mesh)
    if builder.mesh is not None:
        log(f"mesh build over {builder.mesh.devices.size} devices")
    STATS.reset()
    t0 = time.perf_counter()
    index = builder.with_data(data).build(save=False)
    t_pack = time.perf_counter()
    view = index.padded_view()  # materialize the search view inside the clock
    jax.block_until_ready((view.vectors3d, view.ids2d))
    build_s = time.perf_counter() - t0
    build_xfer = STATS.total_s
    xfer_stats = STATS.as_dict()
    phases = dict(getattr(index, "build_profile", {}))
    phases["view_pack"] = round(time.perf_counter() - t_pack, 3)
    log(
        f"build: wall={build_s:.1f}s, host<->device copies {build_xfer:.1f}s "
        f"({xfer_stats['h2d_mb']:.0f} MB h2d, {xfer_stats['d2h_mb']:.0f} MB d2h)"
    )
    log(
        f"build: clusters={index.num_clusters} "
        f"stored={index.num_vectors} (x{index.num_vectors / n:.2f})  "
        f"vectors/sec={n / build_s:,.0f}"
    )
    for name, secs in sorted(phases.items(), key=lambda kv: -kv[1]):
        log(f"  phase {name:<28s} {secs:8.2f}s")

    # nprobe sweep to the target-recall point; QPS measured on the best
    # (lowest-nprobe) config that clears the target.
    best = None
    last = None
    for nprobe in (2, 4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256):
        if nprobe > index.num_clusters:
            break
        ids, _ = index.search(queries, args.k, nprobe=nprobe)  # warm (compile)
        dt = min(
            _timed(lambda: index.search(queries, args.k, nprobe=nprobe))
            for _ in range(3)
        )
        rec = recall_at_k(ids, gt_i, args.k)
        qps = nq / dt
        log(f"[{card}] nprobe={nprobe:4d} recall@{args.k}={rec:.4f} qps={qps:,.0f}")
        last = (nprobe, rec, qps)
        if rec >= args.target_recall:
            best = last
            break
    if best is None:
        # Recall plateaued below target inside the sweep; report the deepest
        # sweep point honestly — vs_baseline scales by the shortfall below.
        nprobe, rec, qps = last
        log(f"TARGET RECALL NOT REACHED: deepest sweep point "
            f"nprobe={nprobe} recall={rec:.4f}")
    else:
        nprobe, rec, qps = best

    # Steady-state QPS: best of 3 on warm programs.
    if qps > 0:
        qps = nq / min(
            _timed(lambda: index.search(queries, args.k, nprobe=nprobe))
            for _ in range(3)
        )
    log(
        f"[{card}] RESULT nprobe={nprobe} ({nprobe / index.num_clusters:.3%} "
        f"of lists) recall={rec:.4f} qps={qps:,.0f} build={build_s:.1f}s"
    )

    print(
        json.dumps(
            {
                "metric": (
                    f"qps_at_recall@{args.k}>={args.target_recall}"
                    f"_gauss{n // 1000}k_{args.dim}d"
                    + (f"_lat{args.latent_dim}" if args.latent_dim else "")
                    + f"_{args.metric.lower()}"
                ),
                "value": round(qps, 1),
                "unit": "qps",
                # Below-target recall scales the score by the shortfall so a
                # plateaued sweep can't report full credit.
                "vs_baseline": round(
                    qps / 10_000.0 * min(1.0, rec / args.target_recall), 3
                ),
                "device": {"platform": devs[0].platform,
                           "kind": devs[0].device_kind, "count": len(devs)},
                "card": card,
                "recall": round(float(rec), 4),
                "storage_dtype": args.storage_dtype,
                "query_wire": args.query_wire or "float32",
                "nprobe": int(nprobe),
                "clusters": int(index.num_clusters),
                "stored_x": round(index.num_vectors / n, 2),
                "build_wall_s": round(build_s, 1),
                "build_xfer_s": round(build_xfer, 1),
                "build_xfer": xfer_stats,
                "build_phases": {
                    k2: v for k2, v in sorted(
                        phases.items(), key=lambda kv: -kv[1]
                    )
                },
            }
        )
    )


if __name__ == "__main__":
    main()
