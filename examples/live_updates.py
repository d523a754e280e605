"""SPFresh live-update walkthrough: build an index, stream inserts and
deletes, watch background split/merge keep it balanced — the capability the
reference scaffolded but never wired (SURVEY.md section 5 quirk 5).
"""

import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spfresh_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

from spfresh_tpu.index import Config, SpannIndexBuilder
from spfresh_tpu.lire import LireConfig, SpFreshIndex
from spfresh_tpu.utils import metrics


def main():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((2000, 16)).astype(np.float32)

    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": 8,
                "desired_cluster_size": 200,
                "rng_seed": 42,
            },
            "output_path": "/tmp/spfresh_example_idx",
        }
    )
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    print(f"built: {index.num_clusters} posting lists")

    store = "/tmp/spfresh_example_store"
    shutil.rmtree(store, ignore_errors=True)
    with SpFreshIndex(
        index, store, LireConfig(max_partition_size=260, min_partition_size=4)
    ) as fresh:
        # Stream inserts into one region until a posting splits.
        hot = rng.standard_normal(16).astype(np.float32)
        before = fresh.index.num_clusters
        for i in range(400):
            fresh.insert(hot + 0.01 * rng.standard_normal(16).astype(np.float32), 10_000 + i)
        fresh.flush()
        print(f"after 400 hot inserts: {fresh.index.num_clusters} posting lists "
              f"(was {before}; background splits rebalanced)")

        # Inserted vectors are immediately searchable.
        ids, dists = fresh.search(hot[None, :], k=5, nprobe=8)
        print("nearest to hot spot:", ids[0].tolist())

        # Delete them again; undersized postings merge away.
        for i in range(400):
            fresh.delete(10_000 + i)
        fresh.flush()
        fresh.repair()
        fresh.flush()
        print(f"after deletes: {fresh.index.num_clusters} posting lists")
        print("pipeline metrics:", {
            k: v for k, v in sorted(metrics.snapshot().items()) if k.startswith("lire")
        })


if __name__ == "__main__":
    main()
