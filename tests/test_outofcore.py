"""Out-of-core build (clustering/outofcore.py + builder/config plumbing).

The capability the reference lacks entirely: its builder materializes the
full corpus in memory (spann_builder.rs:25-64).  Here the corpus stays
host-resident (ndarray or np.memmap) and the device sees only bounded
tiles; these tests pin correctness (coverage, exactness, determinism,
caps), the memory bound (no upload larger than one tile + the centroid
matrix), and the facade plumbing."""

import os

import numpy as np
import pytest

from spfresh_tpu.clustering.hierarchical import ClusteringParams
from spfresh_tpu.clustering.outofcore import fit_outofcore
from spfresh_tpu.eval import recall_at_k
from spfresh_tpu.index import (
    Config,
    LazySpannIndex,
    SpannIndexBuilder,
    brute_force_search,
)


def _corpus(n=12000, d=24, n_centers=40, spread=0.5, seed=7):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    a = rng.integers(0, n_centers, n)
    data = (centers[a] + spread * rng.standard_normal((n, d))).astype(
        np.float32
    )
    q = (
        centers[rng.integers(0, n_centers, 100)]
        + spread * rng.standard_normal((100, d))
    ).astype(np.float32)
    return data, q


def _cfg(tmp_path, **kw):
    base = {
        "clustering_params": {
            "distance_metric": "Euclidean",
            "initialization_method": "KMeans++",
            "initial_k": 8,
            "desired_cluster_size": 250,
            "rng_seed": 42,
        },
        "output_path": str(tmp_path / "oc_idx"),
        "build_sample_rows": 3000,
        "build_tile_rows": 2048,
    }
    cp = kw.pop("clustering_params", {})
    base["clustering_params"].update(cp)
    base.update(kw)
    return Config.from_dict(base)


def test_coverage_exactness_and_caps(tmp_path):
    data, q = _corpus()
    n = len(data)
    cfg = _cfg(tmp_path)
    idx = SpannIndexBuilder(cfg).with_data(data).build(save=False)

    # Every corpus row lands in >= 1 posting and <= max_replicas postings.
    cnt = np.zeros(n, np.int64)
    for _, (ids, _) in idx.postings.items():
        cnt[ids] += 1
    assert cnt.min() >= 1
    assert cnt.max() <= cfg.max_replicas

    # Full-probe search is exactly recall 1.0 (standing invariant).
    gt_d, gt_i = brute_force_search(data, q, 10)
    ids, _ = idx.search(q, 10, nprobe=idx.num_clusters)
    assert recall_at_k(ids, gt_i, 10) == 1.0

    # Posting sizes respect the overflow budget.
    limit = int(np.ceil(cfg.replica_overflow * 250))
    assert max(len(i) for i, _ in idx.postings.values()) <= limit


def test_manhattan_replica_route(tmp_path):
    """The streamed assign and replica passes on an elementwise metric (no
    matmul expansion) keep every build invariant — coverage, replica cap,
    full-probe recall 1.0."""
    data, q = _corpus(n=6000)
    cfg = _cfg(tmp_path, clustering_params={"distance_metric": "Manhattan"})
    idx = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    cnt = np.zeros(len(data), np.int64)
    for _, (ids, _) in idx.postings.items():
        cnt[ids] += 1
    assert cnt.min() >= 1
    assert cnt.max() <= cfg.max_replicas
    _, gt_i = brute_force_search(data, q, 10, metric="Manhattan")
    ids, _ = idx.search(q, 10, nprobe=idx.num_clusters)
    assert recall_at_k(ids, gt_i, 10) == 1.0


def test_deterministic_and_memmap(tmp_path):
    data, _ = _corpus()
    # Corpus served from a read-only memmap: the out-of-core contract.
    mm_path = str(tmp_path / "corpus.f32")
    data.tofile(mm_path)
    mm = np.memmap(mm_path, dtype=np.float32, mode="r", shape=data.shape)

    cfg = _cfg(tmp_path)
    a = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    b = SpannIndexBuilder(cfg).with_data(mm).build(save=False)
    assert len(a.postings) == len(b.postings)
    for c in a.postings:
        assert np.array_equal(a.postings[c][0], b.postings[c][0])
        assert np.array_equal(a.centroids[c], b.centroids[c])


def test_tile_size_does_not_change_results(tmp_path, monkeypatch):
    """The adaptive centroid chunk (_ENTRY_BUDGET scratch guard) must be
    output-invariant: a huge caller tile (small chunk) and the default tile
    produce identical clusters.  Guards the 20M x 96 OOM fix — a 262k-row
    tile at the fixed 8k chunk built 8 GB per-dispatch temps."""
    import spfresh_tpu.clustering.outofcore as oc

    data, _ = _corpus(n=6000)
    a = SpannIndexBuilder(_cfg(tmp_path)).with_data(data).build(save=False)
    # Force the guard to bite: big tile + tiny budget => minimum chunk.
    monkeypatch.setattr(oc, "_ENTRY_BUDGET", 1 << 12)
    big = _cfg(tmp_path, build_tile_rows=6000)
    b = SpannIndexBuilder(big).with_data(data).build(save=False)
    assert sorted(a.postings) == sorted(b.postings)
    for c in a.postings:
        assert np.array_equal(a.postings[c][0], b.postings[c][0])
        assert np.array_equal(a.centroids[c], b.centroids[c])


def test_upload_bound(tmp_path, monkeypatch):
    """No single host->device transfer exceeds one tile (+ the centroid
    matrix): the corpus never rides to the device whole."""
    import spfresh_tpu.clustering.outofcore as oc

    data, _ = _corpus()
    seen = []
    from spfresh_tpu.utils import xfer

    real_put = xfer.timed_put

    def spy_put(arr, *a, **kw):
        seen.append(np.asarray(arr).nbytes)
        return real_put(arr, *a, **kw)

    monkeypatch.setattr(xfer, "timed_put", spy_put)
    params = ClusteringParams(
        metric="Euclidean",
        initialization_method="KMeans++",
        initial_k=8,
        desired_cluster_size=250,
        rng_seed=42,
    )
    tile_rows = 2048
    res = fit_outofcore(params, data, sample_rows=3000, tile_rows=tile_rows)
    assert seen, "streaming passes must route uploads through timed_put"
    tile_bytes = tile_rows * data.shape[1] * 4
    C = len(res.clusters)
    # Centroid matrix upload is padded to the chunk multiple.
    cent_bytes = (
        ((C + 8192 - 1) // 8192 * 8192 if C > 8192 else 8192)
    ) * data.shape[1] * 4
    bound = max(tile_bytes, cent_bytes)
    assert max(seen) <= bound
    # The full corpus is bigger than the bound (i.e. the test means something).
    assert data.nbytes > bound or data.nbytes > tile_bytes


def test_rebalance_splits_oversized(tmp_path):
    """A deliberately bad sample (tiny, uniform corpus, huge scaled cap
    noise) must still end with every base posting <= cap."""
    rng = np.random.default_rng(3)
    # Skewed corpus: 80% of mass in one blob -> sample caps misestimate.
    blob = rng.standard_normal((8000, 16)).astype(np.float32) * 0.1
    rest = rng.standard_normal((2000, 16)).astype(np.float32) + 5.0
    data = np.concatenate([blob, rest])
    params = ClusteringParams(
        metric="Euclidean",
        initialization_method="KMeans++",
        initial_k=4,
        desired_cluster_size=500,
        rng_seed=1,
        max_replicas=1,  # isolate base assignment
    )
    res = fit_outofcore(params, data, sample_rows=400, tile_rows=1024)
    sizes = [len(c.points) for c in res.clusters]
    assert max(sizes) <= 500
    assert sum(sizes) == len(data)  # max_replicas=1: exact partition
    assert res.num_splits >= 0


def test_bf16_storage_wire(tmp_path):
    data, q = _corpus()
    cfg = _cfg(tmp_path, storage_dtype="bfloat16")
    idx = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    gt_d, gt_i = brute_force_search(data, q, 10)
    ids, _ = idx.search(q, 10, nprobe=8)
    assert recall_at_k(ids, gt_i, 10) > 0.9


def test_save_load_and_lazy_open(tmp_path):
    data, q = _corpus()
    cfg = _cfg(tmp_path)
    idx = SpannIndexBuilder(cfg).with_data(data).build(save=True)
    ids0, _ = idx.search(q, 10, nprobe=8)

    re = SpannIndexBuilder(cfg).load()
    ids1, _ = re.search(q, 10, nprobe=8)
    assert np.array_equal(ids0, ids1)

    lazy = LazySpannIndex(cfg.output_path, cfg)
    ids2, _ = lazy.search(q[:32], 10, nprobe=8)
    assert np.array_equal(ids0[:32], ids2)


def test_config_validation(tmp_path):
    with pytest.raises(ValueError, match="build_sample_rows"):
        Config.from_dict({"build_sample_rows": 0})
    with pytest.raises(ValueError, match="build_tile_rows"):
        Config.from_dict({"build_tile_rows": -1})

    data, _ = _corpus(n=2000)
    params = ClusteringParams(initial_k=64, rng_seed=0)
    with pytest.raises(ValueError, match="sample_rows"):
        fit_outofcore(params, data, sample_rows=32)


def test_mesh_outofcore_build_identical(tmp_path):
    """Out-of-core build over a device mesh: tiles round-robin across the
    devices (data parallelism), and the result is bit-identical to the
    single-device out-of-core build — same postings, same centroids."""
    import jax
    from jax.sharding import Mesh

    data, q = _corpus(n=9000)
    a = SpannIndexBuilder(_cfg(tmp_path)).with_data(data).build(save=False)
    mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("shard",))
    b = (
        SpannIndexBuilder(_cfg(tmp_path, output_path=str(tmp_path / "m")), mesh=mesh)
        .with_data(data)
        .build(save=False)
    )
    assert sorted(a.postings) == sorted(b.postings)
    for c in a.postings:
        assert np.array_equal(a.postings[c][0], b.postings[c][0])
        assert np.array_equal(a.centroids[c], b.centroids[c])
    _, gt = brute_force_search(data, q, 10)
    ids, _ = b.search(q, 10, nprobe=b.num_clusters)
    assert recall_at_k(ids, gt, 10) == 1.0


def test_roundtrip_config_dict(tmp_path):
    cfg = _cfg(tmp_path)
    d = cfg.to_dict()
    assert d["build_sample_rows"] == 3000
    cfg2 = Config.from_dict(d)
    assert cfg2.build_sample_rows == 3000
    assert cfg2.build_tile_rows == 2048


def test_outofcore_artifact_takes_live_updates(tmp_path):
    """The DEEP-scale pipeline at test scale: out-of-core build -> packed
    save -> LazySpFreshIndex live inserts/deletes -> compaction, with the
    full-probe oracle holding at every step (the exact chain the 20M demo
    runs; the reference can neither build nor update out of core)."""
    from spfresh_tpu.lire.lazy_fresh import LazySpFreshIndex

    data, q = _corpus(n=6000)
    cfg = _cfg(tmp_path, build_sample_rows=2000)
    SpannIndexBuilder(cfg).with_data(data).build(save=True)

    fresh = LazySpFreshIndex(cfg.output_path, config=cfg)
    try:
        rng = np.random.default_rng(11)
        add = (data[:64] + 0.01 * rng.standard_normal((64, data.shape[1]))).astype(
            np.float32
        )
        vids = list(range(500_000, 500_064))
        fresh.insert_batch(add, vids)
        ids, dists = fresh.search(add, k=1, nprobe=fresh.num_clusters)
        assert set(np.asarray(ids)[:, 0].tolist()) == set(vids)
        fresh.delete_batch(vids[:32])
        fresh.flush()
        ids, _ = fresh.search(add[:32], k=3, nprobe=fresh.num_clusters)
        assert not (set(np.asarray(ids).ravel().tolist()) & set(vids[:32]))
        fresh.compact()
        ids, dists = fresh.search(add[32:], k=1, nprobe=fresh.num_clusters)
        assert set(np.asarray(ids)[:, 0].tolist()) == set(vids[32:])
        assert np.allclose(np.asarray(dists)[:, 0], 0.0, atol=1e-4)
    finally:
        fresh.close()


def test_streaming_packed_save_identical_and_no_cache(tmp_path):
    """The streaming packed writer must produce byte-identical files to the
    eager writer, and a save of a lazily-materialized index must not cache
    posting vectors (RAM = one block, not replication x corpus)."""
    from spfresh_tpu.index.posting_store import (
        write_packed_postings,
        write_packed_postings_streaming,
    )
    from spfresh_tpu.index.spann import _LazyMemberVecs

    data, _ = _corpus(n=4000)
    cfg = _cfg(tmp_path, build_sample_rows=1500)
    idx = SpannIndexBuilder(cfg).with_data(data).build(save=True)

    # No posting cached its materialized block during save.
    lazies = [
        v for _, (i, v) in idx.postings.items() if isinstance(v, _LazyMemberVecs)
    ]
    assert lazies, "fresh build should hold lazy member views"
    assert all(v._mat is None for v in lazies), "save cached posting vectors"

    # Byte equality of the two writers on the same CSR arrays.
    cids = sorted(idx.postings)
    lens = np.array([len(idx.postings[c][0]) for c in cids], np.int64)
    offsets = np.zeros(len(cids) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    ids = np.concatenate([idx.postings[c][0] for c in cids])
    vecs = np.concatenate([np.asarray(idx.postings[c][1], np.float32) for c in cids])
    pa, pb = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    write_packed_postings(pa, cids, offsets, ids, vecs)
    write_packed_postings_streaming(
        pb, cids, offsets, ids,
        (np.asarray(idx.postings[c][1], np.float32) for c in cids),
        data.shape[1],
    )
    assert open(pa, "rb").read() == open(pb, "rb").read()
