"""Multi-device walkthrough: build OVER a device mesh, search with
per-shard top-k + collective merge, land a live update in the sharded view
in place.

The reference is single-process (SURVEY.md §2 parallelism: rayon threads
only); here the scale-out axis is the corpus — postings and centroids
sharded over a `jax.sharding.Mesh`, per-shard scan/rerank, `all_gather`
merge.

Runs on the GPUs present (2 or more).  With ``JAX_PLATFORMS=cpu`` it runs on
a virtual 8-device CPU mesh (`--xla_force_host_platform_device_count`), the
mechanism the test suite uses.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("JAX_PLATFORMS") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

from spfresh_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402

from spfresh_tpu.index import Config, SpannIndexBuilder  # noqa: E402
from spfresh_tpu.parallel import ShardedSpannIndex  # noqa: E402


def main():
    if jax.device_count() < 2:
        raise SystemExit(
            f"needs 2+ devices, found {jax.device_count()} "
            f"{jax.devices()[0].platform} device(s); set JAX_PLATFORMS=cpu "
            "for a virtual CPU mesh"
        )
    rng = np.random.default_rng(0)
    data = rng.standard_normal((4000, 32)).astype(np.float32)
    print(f"devices: {jax.device_count()} x {jax.devices()[0].platform}")

    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": 8,
                "desired_cluster_size": 250,
                "rng_seed": 42,
            },
            "output_path": "/tmp/spfresh_sharded_example",
        }
    )

    # Build WITH the mesh: assign/medoid, multi-way subdivision, and the
    # replica pass all run data-parallel over the devices (bit-identical to
    # the single-device build — the tests assert it).
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()), ("shard",))
    index = SpannIndexBuilder(cfg, mesh=mesh).with_data(data).build(save=False)

    sharded = ShardedSpannIndex(index, mesh=mesh, axis="shard")
    queries = data[:16] + 0.01 * rng.standard_normal((16, 32)).astype(np.float32)
    ids, dists = sharded.search(queries, k=5, nprobe=index.num_clusters)
    assert (ids[np.arange(16), 0] == np.arange(16)).all(), "self-NN failed"
    print(f"sharded full-probe search over {index.num_clusters} postings: "
          f"self-NN exact for all {len(queries)} queries")

    # Live update: append two vectors to one posting; the sharded padded
    # view scatters them in place (no rebuild) and search sees them.
    cid = sorted(index.postings)[0]
    pids, pvecs = index.postings[cid]
    new = rng.standard_normal((2, 32)).astype(np.float32)
    index.replace_posting(
        cid,
        np.concatenate([np.asarray(pids), [90_000, 90_001]]),
        np.concatenate([np.asarray(pvecs), new]),
    )
    ids2, _ = sharded.search(new[:1], k=1, nprobe=index.num_clusters)
    assert int(ids2[0, 0]) == 90_000
    print("live insert landed in the sharded view in place; search sees id 90000")


if __name__ == "__main__":
    main()
