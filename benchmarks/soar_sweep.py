"""SOAR replica-ranking sweep: recall@k vs nprobe for soar_lambda values.

SOAR (ScaNN's spilled, orthogonality-amplified residuals) ranks admitted
closure candidates by D + lambda (r_j.r_1)^2/|r_1|^2 instead of plain
distance: replicas whose residual is orthogonal to the primary's recover
more recall per stored copy when routing misses the base cluster.  This
harness measures whether that holds on the bench corpus model at fixed
max_replicas, and at which lambda.

    python benchmarks/soar_sweep.py --n 100000 --dim 128 --lambdas 0,0.5,1,2
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spfresh_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import time

import numpy as np

from spfresh_tpu.eval import recall_at_k
from spfresh_tpu.index import Config, SpannIndexBuilder, brute_force_search


def corpus(n, dim, nq, spread, seed=7):
    rng = np.random.default_rng(seed)
    n_centers = max(64, n // 1000)
    centers = rng.standard_normal((n_centers, dim)).astype(np.float32)

    def draw(m):
        a = rng.integers(0, n_centers, m)
        return (
            centers[a] + spread * rng.standard_normal((m, dim))
        ).astype(np.float32)

    return draw(n), draw(nq)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--nq", type=int, default=1000)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--spread", type=float, default=0.7)
    p.add_argument("--cluster-size", type=int, default=256)
    p.add_argument("--max-replicas", type=int, default=4)
    p.add_argument("--lambdas", default="0,0.5,1,2")
    p.add_argument("--nprobes", default="2,4,8,16,32")
    p.add_argument("--storage-dtype", default="bfloat16")
    args = p.parse_args()

    data, q = corpus(args.n, args.dim, args.nq, args.spread)
    _, gt = brute_force_search(data, q, args.k)
    nprobes = [int(s) for s in args.nprobes.split(",")]
    print(f"n={args.n} dim={args.dim} spread={args.spread} "
          f"mr={args.max_replicas} storage={args.storage_dtype}")
    header = "lambda  stored_x  " + "  ".join(f"r@np={np_:<4d}" for np_ in nprobes)
    print(header)
    for lam_s in args.lambdas.split(","):
        lam = float(lam_s)
        cfg = Config.from_dict(
            {
                "clustering_params": {
                    "initialization_method": "KMeans++",
                    "initial_k": 16,
                    "desired_cluster_size": args.cluster_size,
                    "rng_seed": 42,
                    "max_replicas": args.max_replicas,
                    "soar_lambda": lam if lam > 0 else None,
                },
                "storage_dtype": args.storage_dtype,
                "output_path": "/tmp/spann_soar_sweep",
            }
        )
        t0 = time.perf_counter()
        idx = SpannIndexBuilder(cfg).with_data(data).build(save=False)
        build_s = time.perf_counter() - t0
        row = [f"{lam:5.2f}", f"{idx.num_vectors / args.n:8.2f}"]
        for np_ in nprobes:
            ids, _ = idx.search(q, args.k, nprobe=np_)
            row.append(f"{recall_at_k(ids, gt, args.k):9.4f}")
        print("  ".join(row) + f"   (build {build_s:.1f}s, "
              f"C={idx.num_clusters})")


if __name__ == "__main__":
    main()
