"""Disk-backed live updates: the SPFresh deployment shape (SSD tier).

Build once, save the packed layout, then serve inserts/deletes/searches
with the corpus staying ON DISK — HBM holds only the centroid routing
tier and host RAM only the delta overlay (SURVEY.md §5; reference memory
model spann_index.rs:169 "lazy design").  Splits/merges run in the
background through the same LIRE pipeline as the in-RAM index, and
``compact()`` folds the overlay back into a fresh packed base.
"""

import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spfresh_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

from spfresh_tpu.index import Config, SpannIndexBuilder
from spfresh_tpu.lire import LazySpFreshIndex, LireConfig


def main():
    rng = np.random.default_rng(0)
    n, d = 5000, 32
    data = rng.standard_normal((n, d)).astype(np.float32)

    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": 8,
                "desired_cluster_size": 250,
                "rng_seed": 42,
            },
        }
    )
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    idx_dir = "/tmp/spfresh_disk_idx"
    shutil.rmtree(idx_dir, ignore_errors=True)
    index.save(idx_dir, format="packed")
    print(f"built+saved: {index.num_clusters} posting lists -> {idx_dir}")

    with LazySpFreshIndex(
        idx_dir, lire_config=LireConfig(max_partition_size=320, min_partition_size=4)
    ) as fresh:
        # Stream inserts into one region until postings split.
        hot = rng.standard_normal(d).astype(np.float32)
        before = fresh.num_clusters
        batch = hot + 0.01 * rng.standard_normal((400, d)).astype(np.float32)
        fresh.insert_batch(batch, np.arange(10_000, 10_400))
        fresh.flush()
        print(f"after 400 hot inserts: {fresh.num_clusters} posting lists "
              f"(was {before}); overlay rows: {fresh.storage.overlay_rows()}")

        # Inserted vectors are immediately searchable — the staged slabs
        # are patched against the overlay per batch.
        ids, dists = fresh.search(hot[None, :], k=5, nprobe=8)
        print("nearest to hot spot:", ids[0].tolist())

        # Delete them again; tombstones ride the overlay + WAL.
        fresh.delete_batch(np.arange(10_000, 10_400))
        fresh.flush()
        ids, _ = fresh.search(hot[None, :], k=5, nprobe=8)
        assert not (set(ids[0].tolist()) & set(range(10_000, 10_400)))
        print(f"after deletes: {fresh.num_clusters} posting lists")

        # Fold the overlay into a fresh packed base (streamed, crash-safe).
        fresh.compact()
        print(f"compacted: overlay rows now {fresh.storage.overlay_rows()}")
        ids, _ = fresh.search(data[:1], k=1, nprobe=fresh.num_clusters)
        print("self-query after compaction returns id", int(ids[0, 0]))
        assert int(ids[0, 0]) == 0


if __name__ == "__main__":
    main()
