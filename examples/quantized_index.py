"""int8 residual-quantized index walkthrough (beyond the reference).

Builds the same clustered corpus twice — float32 and int8 (residual
IVF-SQ8) — and compares recall, reported distances, and view HBM bytes.
The int8 tier stores per-posting-scaled residual codes: slabs cost 1/4 of
f32 (1/2 of bfloat16) in HBM and rerank DMA, with the quantization step
set by each posting's cluster radius.  The on-disk format stays exact
f32, so a saved index can be re-opened under any storage dtype.

Run: python examples/quantized_index.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spfresh_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from spfresh_tpu.eval import recall_at_k
from spfresh_tpu.index import Config, SpannIndexBuilder, brute_force_search

rng = np.random.default_rng(7)
n, dim, n_centers = 20_000, 64, 128
centers = rng.standard_normal((n_centers, dim)).astype(np.float32)
data = (
    centers[rng.integers(0, n_centers, n)]
    + 0.5 * rng.standard_normal((n, dim))
).astype(np.float32)
queries = (
    centers[rng.integers(0, n_centers, 500)]
    + 0.5 * rng.standard_normal((500, dim))
).astype(np.float32)
gt_d, gt_i = brute_force_search(data, queries, 10)

for sd in ("float32", "int8"):
    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": 16,
                "desired_cluster_size": 256,
                "rng_seed": 42,
            },
            "output_path": f"/tmp/spfresh_quant_{sd}",
            "storage_dtype": sd,
        }
    )
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    ids, dists = index.search(queries, 10, nprobe=8)
    view = index.padded_view()
    slab_mb = view.vectors3d.size * view.vectors3d.dtype.itemsize / 2**20
    print(
        f"{sd:8s}  recall@10={recall_at_k(ids, gt_i, 10):.4f}  "
        f"slab HBM={slab_mb:7.1f} MB  "
        f"top-1 dist err={np.abs(dists[:, 0] - gt_d[:, 0]).mean():.4f}"
    )
