"""Model-based fuzz for the out-of-core build tier (clustering/outofcore.py).

The 100M-scale flagship path (the reference's builder materializes the
whole corpus in RAM, spann_builder.rs:25-64) gets the same treatment the
storage/fresh/view tiers already have: random corpora + random configs
driven against the tier's hard contracts, with the catching seeds pinned
in CI and fresh seeds ground by ``tests/marathon.py`` (suite ``oc``).

Oracles per seed (two builds):

  build A (ndarray corpus, random tile size):
    1. coverage — every corpus row lands in >= 1 posting;
    2. replica cap — no row appears in more than ``max_replicas`` postings,
       and no posting exceeds ceil(replica_overflow * desired_cluster_size);
    3. full-probe recall EXACTLY 1.0 (f32 storage; the standing invariant);
    4. partial-probe dedup — a point id never appears twice in one result
       row.
  build B (same rng_seed, corpus served from a read-only np.memmap, a
  DIFFERENT tile size):
    5. postings + centroids bit-identical to build A — one build checks
       determinism, tile-size invariance and memmap-vs-ndarray equivalence
       at once.

Adversarial corpus shapes are mixed in: exact duplicate rows (top-k ties),
constant rows, and corpora barely larger than the fit sample.
"""

from pathlib import Path

import numpy as np
import pytest

from spfresh_tpu.eval import recall_at_k
from spfresh_tpu.index import Config, SpannIndexBuilder, brute_force_search

# Seeds that caught a real bug get pinned here (none yet); 3 fresh seeds
# keep the suite live in CI.
CI_SEEDS = [0, 1, 2]


def _random_case(rng: np.random.Generator):
    n = int(rng.integers(2500, 6500))
    d = int(rng.integers(4, 40))
    n_centers = int(rng.integers(4, 50))
    spread = float(rng.uniform(0.2, 1.0))
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    a = rng.integers(0, n_centers, n)
    data = (centers[a] + spread * rng.standard_normal((n, d))).astype(
        np.float32
    )
    shape_kind = rng.integers(0, 10)
    if shape_kind == 0:
        # Exact duplicates: the first 10% of rows repeated verbatim.
        k = max(1, n // 10)
        data[-k:] = data[:k]
    elif shape_kind == 1:
        # Constant rows sprinkled in (zero variance within the block).
        k = max(1, n // 20)
        data[:k] = data[0]
    q = (
        centers[rng.integers(0, n_centers, 64)]
        + spread * rng.standard_normal((64, d))
    ).astype(np.float32)

    sample_rows = int(rng.integers(400, min(n, 4000)))
    if shape_kind == 2:
        # Corpus barely larger than the fit sample.
        sample_rows = n - int(rng.integers(1, 50))
    cfg = {
        "clustering_params": {
            "distance_metric": "Euclidean",
            "initialization_method": (
                "KMeans++" if rng.integers(0, 2) else "Random"
            ),
            "initial_k": int(rng.integers(2, 10)),
            "desired_cluster_size": int(rng.integers(100, 700)),
            "rng_seed": int(rng.integers(0, 2**31)),
            "max_replicas": int(rng.integers(1, 7)),
            "boundary_threshold": float(rng.uniform(1.0, 1.4)),
        },
        "build_sample_rows": sample_rows,
    }
    tiles = rng.choice([512, 1024, 2048, 4097], size=2, replace=False)
    return data, q, cfg, (int(tiles[0]), int(tiles[1]))


def _build(tmp_path, data, cfg, tile_rows, tag):
    raw = {
        **cfg,
        "clustering_params": dict(cfg["clustering_params"]),
        "output_path": str(tmp_path / f"oc_{tag}"),
        "build_tile_rows": tile_rows,
    }
    return SpannIndexBuilder(Config.from_dict(raw)).with_data(data).build(
        save=False
    )


def run_outofcore_model_fuzz(tmp_path, seed):
    rng = np.random.default_rng(seed ^ 0x0C0C)
    data, q, cfg, (tile_a, tile_b) = _random_case(rng)
    n = len(data)
    cp = cfg["clustering_params"]
    idx = _build(tmp_path, data, cfg, tile_a, "a")

    # 1+2: coverage and the replica/overflow caps.
    cnt = np.zeros(n, np.int64)
    for _, (ids, _) in idx.postings.items():
        assert len(set(ids.tolist())) == len(ids), "dup id within a posting"
        cnt[ids] += 1
    assert cnt.min() >= 1, "row missing from every posting"
    assert cnt.max() <= cp["max_replicas"]
    limit = int(np.ceil(1.25 * cp["desired_cluster_size"]))
    assert max(len(i) for i, _ in idx.postings.values()) <= limit

    # 3: full-probe search is exactly recall 1.0 (f32 storage).
    _, gt_i = brute_force_search(data, q, 10)
    ids, _ = idx.search(q, 10, nprobe=idx.num_clusters)
    assert recall_at_k(ids, gt_i, 10) == 1.0

    # 4: partial-probe rows never repeat an id.
    ids_p, _ = idx.search(q, 10, nprobe=max(1, idx.num_clusters // 4))
    for row in np.asarray(ids_p):
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)

    # 5: second build — memmap corpus, different tile — must be
    # bit-identical (determinism + tile invariance + memmap parity in one
    # check).
    mm_path = str(tmp_path / "corpus.f32")
    data.tofile(mm_path)
    mm = np.memmap(mm_path, dtype=np.float32, mode="r", shape=data.shape)
    idx2 = _build(tmp_path, mm, cfg, tile_b, "b")
    assert sorted(idx.postings) == sorted(idx2.postings)
    for c in idx.postings:
        np.testing.assert_array_equal(idx.postings[c][0], idx2.postings[c][0])
        np.testing.assert_array_equal(idx.centroids[c], idx2.centroids[c])


@pytest.mark.parametrize("seed", CI_SEEDS)
def test_outofcore_model_fuzz(tmp_path, seed):
    run_outofcore_model_fuzz(tmp_path, seed)
