"""End-to-end recall evaluation driver (parity: /root/reference/src/main.rs:87-115).

Runs against SIFT-format fvecs/ivecs files when given, otherwise against a
seeded synthetic Gaussian dataset with exact on-device ground truth (the
reference's criterion bench data model, benches/clustering_benchmark.rs:11-15).

Usage:
    python examples/sift_eval.py [--base base.fvecs --query query.fvecs \
        --gt groundtruth.ivecs] [--n 10000] [--dim 128] [--k 10]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spfresh_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import argparse
import logging
import time

import numpy as np

from spfresh_tpu.eval import evaluate, make_groundtruth, nprobe_sweep
from spfresh_tpu.index import Config, SpannIndexBuilder
from spfresh_tpu.io import read_fvecs, read_ivecs

logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", help="fvecs base set")
    ap.add_argument("--query", help="fvecs query set")
    ap.add_argument("--gt", help="ivecs ground truth")
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--nq", type=int, default=100)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--cluster-size", type=int, default=256)
    ap.add_argument("--initial-k", type=int, default=16)
    ap.add_argument("--sweep", action="store_true", help="run an nprobe sweep")
    ap.add_argument("--storage-dtype", default="float32",
                    help="float32 | bfloat16 | int8 (residual IVF-SQ8)")
    args = ap.parse_args()

    if args.base:
        data = read_fvecs(args.base)
        queries = read_fvecs(args.query)
        gt = read_ivecs(args.gt)[:, : args.k]
    else:
        rng = np.random.default_rng(12345)
        data = rng.standard_normal((args.n, args.dim)).astype(np.float32)
        queries = rng.standard_normal((args.nq, args.dim)).astype(np.float32)
        gt = make_groundtruth(data, queries, args.k)

    cfg = Config.from_dict(
        {
            "clustering_params": {
                "distance_metric": "Euclidean",
                "initialization_method": "KMeans++",
                "initial_k": args.initial_k,
                "desired_cluster_size": args.cluster_size,
                "rng_seed": 42,
            },
            "output_path": "/tmp/spann_sift_eval",
            "storage_dtype": args.storage_dtype,
        }
    )
    t0 = time.perf_counter()
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    print(f"build: {time.perf_counter() - t0:.2f}s  clusters={index.num_clusters}  "
          f"vectors={index.num_vectors} (replication x{index.num_vectors / len(data):.2f})")

    if args.sweep:
        for r in nprobe_sweep(index, queries, gt, k=args.k):
            print(f"nprobe={r.nprobe:4d}  recall@{args.k}={r.recall:.4f}  qps={r.qps:,.0f}")
    else:
        r = evaluate(index, queries, gt, k=args.k, nprobe=32)
        print(f"recall@{args.k}={r.recall:.4f}  qps={r.qps:,.0f}")


if __name__ == "__main__":
    main()
