"""SPANN index tests: config validation (config.rs:59-87 parity), posting
store roundtrips (posting_lists.rs tests), end-to-end build/search on the
reference's toy example (examples/build_index.rs: query (1,2) with k=1 must
return point_id 0), save/load roundtrip, and recall vs. brute force."""

import os

import numpy as np
import pytest

from spfresh_tpu.index import (
    Config,
    FileBasedPostingListStore,
    SpannIndex,
    SpannIndexBuilder,
    brute_force_search,
)
from spfresh_tpu.index.posting_store import read_packed_postings, write_packed_postings


# -- config ----------------------------------------------------------------


def test_config_defaults_and_validation(tmp_path):
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text(
        "clustering_params:\n"
        "  distance_metric: \"Euclidean\"\n"
        "  initialization_method: \"Random\"\n"
        "  initial_k: 4\n"
        f"output_path: \"{tmp_path / 'out'}\"\n"
    )
    cfg = Config.from_file(str(cfg_file))
    assert cfg.initial_k == 4
    assert cfg.distance_metric == "Euclidean"
    params = cfg.to_clustering_params()
    assert params.initial_k == 4
    assert params.desired_cluster_size is None  # builder supplies 0.18n


def test_config_replication_knobs_reach_build(rng):
    """boundary_threshold / replica_overflow flow Config -> ClusteringParams ->
    build, and a wider boundary stores strictly more replicas.  (bt=1.0 does
    NOT force zero replicas: the base cluster comes from the hierarchical
    assignment, and a different final medoid can be strictly nearer.)"""
    base = {"clustering_params": {"initial_k": 4, "rng_seed": 7,
                                  "boundary_threshold": 1.0,
                                  "replica_overflow": 1.5}}
    cfg = Config.from_dict(base)
    assert cfg.boundary_threshold == 1.0 and cfg.replica_overflow == 1.5
    p = cfg.to_clustering_params()
    assert p.boundary_threshold == 1.0 and p.replica_overflow == 1.5
    cfg2 = Config.from_dict(cfg.to_dict())
    assert cfg2.boundary_threshold == 1.0 and cfg2.replica_overflow == 1.5

    n, d = 600, 8
    centers = rng.normal(size=(6, d)).astype(np.float32) * 4.0
    data = (centers[rng.integers(0, 6, size=n)]
            + rng.normal(size=(n, d)).astype(np.float32) * 0.3)
    idx_tight = SpannIndexBuilder(cfg).with_data(data).build()
    assert idx_tight.num_vectors >= n

    cfg_wide = Config.from_dict(
        {"clustering_params": {"initial_k": 4, "rng_seed": 7,
                               "boundary_threshold": 1.4}})
    idx_wide = SpannIndexBuilder(cfg_wide).with_data(data).build()
    assert idx_wide.num_vectors > idx_tight.num_vectors


@pytest.mark.parametrize(
    "bad",
    [
        {"clustering_params": {"distance_metric": "Cosine"}},
        {"clustering_params": {"initialization_method": "FarthestFirst"}},
        {"clustering_params": {"initial_k": 0}},
        {"search": {"nprobe": -1}},
        {"search": {"prune_factor": 0.5}},
    ],
)
def test_config_rejects_invalid(bad):
    with pytest.raises(ValueError):
        Config.from_dict(bad)


# -- posting store ---------------------------------------------------------


def test_file_posting_store_roundtrip(tmp_path, rng):
    store = FileBasedPostingListStore(str(tmp_path))
    ids = np.array([3, 1, 4], np.int64)
    vecs = rng.standard_normal((3, 5)).astype(np.float32)
    store.insert_posting_list(7, ids, vecs)
    got = store.get_posting_list(7)
    assert got is not None
    np.testing.assert_array_equal(got[0], ids)
    np.testing.assert_allclose(got[1], vecs)
    assert store.get_posting_list(99) is None

    # Lazy reload: manifest only (posting_lists.rs:115-129)
    store2 = FileBasedPostingListStore.load_from_directory(str(tmp_path))
    assert store2.cluster_ids() == [7]
    got2 = store2.get_posting_list(7)
    np.testing.assert_allclose(got2[1], vecs)

    store2.delete_posting_list(7)
    assert store2.get_posting_list(7) is None


def test_packed_postings_roundtrip(tmp_path, rng):
    path = str(tmp_path / "p.csr")
    offsets = np.array([0, 2, 5], np.int64)
    ids = np.array([10, 11, 20, 21, 22], np.int64)
    vecs = rng.standard_normal((5, 3)).astype(np.float32)
    write_packed_postings(path, [4, 9], offsets, ids, vecs)
    for mmap in (True, False):
        cids, offs, rids, rvecs = read_packed_postings(path, mmap=mmap)
        np.testing.assert_array_equal(np.asarray(cids), [4, 9])
        np.testing.assert_array_equal(np.asarray(offs), offsets)
        np.testing.assert_array_equal(np.asarray(rids), ids)
        np.testing.assert_allclose(np.asarray(rvecs), vecs)


# -- end-to-end toy slice (reference examples) -----------------------------


def _toy_config(tmp_path, **kw):
    return Config.from_dict(
        {
            "clustering_params": {
                "distance_metric": "Euclidean",
                "initialization_method": "Random",
                "initial_k": 4,
                "rng_seed": 42,
                **kw.pop("clustering_params", {}),
            },
            "output_path": str(tmp_path / "data"),
            **kw,
        }
    )


def test_toy_build_and_query(tmp_path, toy_data):
    # examples/build_index.rs: 6x2 data, k=4, Euclidean, query (1,2) k=1 -> id 0
    index = SpannIndexBuilder(_toy_config(tmp_path)).with_data(toy_data).build(dim=2)
    result = index.find_k_nearest_neighbor_spann(np.array([1.0, 2.0]), k=1)
    assert result is not None
    assert result[0].point_id == 0
    np.testing.assert_allclose(result[0].vector, [1.0, 2.0])


def test_toy_load_and_query(tmp_path, toy_data):
    # examples/load_index.rs: reload from disk, same answer.
    cfg = _toy_config(tmp_path)
    SpannIndexBuilder(cfg).with_data(toy_data).build(dim=2)
    loaded = SpannIndexBuilder(cfg).load(dim=2)
    result = loaded.find_k_nearest_neighbor_spann(np.array([1.0, 2.0]), k=1)
    assert result[0].point_id == 0


def test_dim_mismatch_rejected(tmp_path, toy_data):
    with pytest.raises(ValueError):
        SpannIndexBuilder(_toy_config(tmp_path)).with_data(toy_data).build(dim=3)


def test_save_load_roundtrip_both_layouts(tmp_path, rng):
    data = rng.standard_normal((80, 6)).astype(np.float32)
    cfg = _toy_config(tmp_path, clustering_params={"desired_cluster_size": 16})
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    queries = rng.standard_normal((5, 6)).astype(np.float32)
    base_ids, base_d = index.search(queries, k=5, nprobe=4)
    for layout in ("packed", "per_cluster"):
        d = str(tmp_path / layout)
        index.save(d, format=layout)
        loaded = SpannIndex.load(d)
        ids, dists = loaded.search(queries, k=5, nprobe=4)
        np.testing.assert_array_equal(ids, base_ids)
        np.testing.assert_allclose(dists, base_d, rtol=1e-5)


# -- search semantics ------------------------------------------------------


def test_search_batched_matches_single(tmp_path, rng):
    data = rng.standard_normal((200, 8)).astype(np.float32)
    cfg = _toy_config(tmp_path, clustering_params={"desired_cluster_size": 32, "initial_k": 3})
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    queries = rng.standard_normal((10, 8)).astype(np.float32)
    ids_all, d_all = index.search(queries, k=3, nprobe=4)
    for i in [0, 5, 9]:
        ids_one, d_one = index.search(queries[i], k=3, nprobe=4)
        np.testing.assert_array_equal(ids_one[0], ids_all[i])


def test_search_full_probe_is_exact(tmp_path, rng):
    # Probing every posting list with no pruning must equal brute force.
    data = rng.standard_normal((150, 8)).astype(np.float32)
    cfg = _toy_config(tmp_path, clustering_params={"desired_cluster_size": 25, "initial_k": 3})
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    queries = rng.standard_normal((8, 8)).astype(np.float32)
    ids, dists = index.search(queries, k=10, nprobe=index.num_clusters)
    gt_d, gt_i = brute_force_search(data, queries, k=10)
    recall = np.mean([len(set(ids[q]) & set(gt_i[q])) / 10 for q in range(8)])
    assert recall == 1.0
    np.testing.assert_allclose(np.sort(dists, axis=1), np.sort(gt_d, axis=1), rtol=1e-4)


def test_search_respects_metric(tmp_path, rng):
    # Quirk-1 fix: rerank uses the configured metric, not hardwired L2.
    data = rng.standard_normal((100, 6)).astype(np.float32)
    cfg = _toy_config(
        tmp_path,
        clustering_params={"distance_metric": "Manhattan", "desired_cluster_size": 20},
    )
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    queries = rng.standard_normal((4, 6)).astype(np.float32)
    ids, dists = index.search(queries, k=5, nprobe=index.num_clusters)
    gt_d, gt_i = brute_force_search(data, queries, k=5, metric="Manhattan")
    for q in range(4):
        assert set(ids[q]) == set(gt_i[q])


def test_recall_at_10_reasonable(tmp_path, rng):
    data = rng.standard_normal((2000, 16)).astype(np.float32)
    cfg = _toy_config(
        tmp_path,
        clustering_params={
            "initialization_method": "KMeans++",
            "initial_k": 8,
            "desired_cluster_size": 100,
        },
    )
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    queries = rng.standard_normal((20, 16)).astype(np.float32)
    _, gt_i = brute_force_search(data, queries, k=10)
    # Unstructured Gaussian data is the hard case for IVF-style indexes;
    # probing half the lists should still recover most true neighbors.
    nprobe = max(1, index.num_clusters // 2)
    ids, _ = index.search(queries, k=10, nprobe=nprobe)
    recall = np.mean([len(set(ids[q]) & set(gt_i[q])) / 10 for q in range(20)])
    assert recall >= 0.8, f"recall@10 {recall} too low at nprobe={nprobe}"
    # And recall must be monotone-ish in nprobe: full probe is exact.
    ids_full, _ = index.search(queries, k=10, nprobe=index.num_clusters)
    recall_full = np.mean([len(set(ids_full[q]) & set(gt_i[q])) / 10 for q in range(20)])
    assert recall_full == 1.0


def test_pruning_can_drop_candidates(tmp_path, toy_data):
    cfg = _toy_config(tmp_path)
    index = SpannIndexBuilder(cfg).with_data(toy_data).build(save=False)
    # Very tight prune factor: far-away candidates masked to inf -> id slots -1.
    ids, dists = index.search(np.array([[100.0, 100.0]]), k=6, nprobe=1, prune_factor=1.0)
    assert (ids == -1).any() or np.isinf(dists).any() or len(ids[0]) == 6


def test_replica_dedup(tmp_path):
    # Points replicated into several posting lists must not appear twice.
    rng = np.random.default_rng(0)
    data = rng.standard_normal((60, 4)).astype(np.float32)
    cfg = _toy_config(tmp_path, clustering_params={"desired_cluster_size": 15, "initial_k": 3})
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    assert index.num_vectors >= 60  # replication happened (or at least coverage)
    ids, _ = index.search(data[:10], k=10, nprobe=index.num_clusters)
    for row in ids:
        row = row[row >= 0]
        assert len(set(row.tolist())) == len(row)


def test_lazy_index_matches_resident(tmp_path, rng):
    from spfresh_tpu.index import LazySpannIndex

    data = rng.standard_normal((200, 12)).astype(np.float32)
    cfg = _toy_config(tmp_path, clustering_params={"desired_cluster_size": 30, "initial_k": 3})
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    d = str(tmp_path / "lazy")
    index.save(d, format="packed")
    with LazySpannIndex(d) as lazy:
        q = rng.standard_normal((7, 12)).astype(np.float32)
        nprobe = index.num_clusters
        ids_r, d_r = index.search(q, k=5, nprobe=nprobe)
        ids_l, d_l = lazy.search(q, k=5, nprobe=nprobe)
        np.testing.assert_array_equal(ids_r, ids_l)
        np.testing.assert_allclose(d_r, d_l, rtol=1e-5)


def test_bfloat16_storage_search(tmp_path, rng):
    # bf16 HBM storage with f32 accumulation: recall should match f32 almost
    # everywhere (bf16 has ~3 decimal digits; neighbors are well-separated).
    data = rng.standard_normal((150, 16)).astype(np.float32)
    base = _toy_config(tmp_path, clustering_params={"desired_cluster_size": 30})
    cfg16 = Config.from_dict({**base.to_dict(), "storage_dtype": "bfloat16"})
    i32 = SpannIndexBuilder(base).with_data(data).build(save=False)
    i16 = SpannIndexBuilder(cfg16).with_data(data).build(save=False)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    ids32, _ = i32.search(q, k=5, nprobe=i32.num_clusters)
    ids16, _ = i16.search(q, k=5, nprobe=i16.num_clusters)
    overlap = np.mean([len(set(ids32[r]) & set(ids16[r])) / 5 for r in range(6)])
    assert overlap >= 0.8


def test_high_dim_not_multiple_of_128(tmp_path, rng):
    # GIST-like: d=60 pads to 128 in the slab layout; all engines agree.
    data = rng.standard_normal((120, 60)).astype(np.float32)
    cfg = _toy_config(tmp_path, clustering_params={"desired_cluster_size": 25, "initial_k": 3})
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    q = rng.standard_normal((4, 60)).astype(np.float32)
    ids_x, d_x = index.search(q, k=5, nprobe=index.num_clusters, engine="csr")
    ids_p, d_p = index.search(q, k=5, nprobe=index.num_clusters, engine="slab")
    np.testing.assert_array_equal(ids_x, ids_p)
    _, gt = brute_force_search(data, q, k=5)
    for r in range(4):
        assert set(ids_x[r]) == set(gt[r])


# -- lazy bulk-build member vectors ---------------------------------------


def test_bulk_build_member_vecs_are_lazy_and_correct(tmp_path, rng):
    from spfresh_tpu.index.spann import _LazyMemberVecs

    data = rng.standard_normal((120, 6)).astype(np.float32)
    cfg = _toy_config(tmp_path, clustering_params={"desired_cluster_size": 24})
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    # The builder hands the device corpus over, so bulk postings defer the
    # host gather until someone actually reads the vectors.
    lazies = [v for _, v in index.postings.values() if isinstance(v, _LazyMemberVecs)]
    assert lazies, "bulk build should produce lazy member vectors"
    assert all(v._mat is None for v in lazies)
    for ids, vecs in index.postings.values():
        np.testing.assert_array_equal(np.asarray(vecs), data[ids])
        assert vecs.shape == (len(ids), 6) and len(vecs) == len(ids)
        if len(ids) > 1:  # slicing materializes just like an ndarray
            np.testing.assert_array_equal(vecs[1:], data[ids[1:]])
    # Searches (which pack from the device corpus) never needed the host copy.
    q = data[:3]
    ids_l, _ = index.search(q, k=3, nprobe=index.num_clusters)
    gt_d, gt_i = brute_force_search(data, q, k=3)
    assert all(set(ids_l[i]) == set(gt_i[i]) for i in range(3))


def test_probe_chunked_kernel_matches_plain(tmp_path, rng):
    # Full probe through the chunked path (an internal fori_loop with a
    # running bounded candidate set) must equal the one-shot gather kernel.
    from spfresh_tpu.index.spann import (
        _search_kernel,
        _search_kernel_probe_chunked,
    )
    import jax.numpy as jnp

    data = rng.standard_normal((300, 8)).astype(np.float32)
    cfg = _toy_config(tmp_path, clustering_params={"desired_cluster_size": 30, "initial_k": 4})
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    view = index.device_view()
    q = jnp.asarray(rng.standard_normal((9, 8)).astype(np.float32))
    C = int(view.centroids.shape[0])
    nprobe = index.num_clusters
    common = dict(k=5, nprobe=nprobe, pad=view.pad, metric="Euclidean",
                  prune=False, max_dup=view.max_dup)
    ids_p, d_p = _search_kernel(
        q, view.centroids, view.cent_valid, view.offsets, view.lens,
        view.ids, view.vectors, view.scales, jnp.float32(0.0), **common)
    for pc in (1, 3, nprobe):
        ids_c, d_c = _search_kernel_probe_chunked(
            q, view.centroids, view.cent_valid, view.offsets, view.lens,
            view.ids, view.vectors, view.scales, jnp.float32(0.0),
            probe_chunk=pc, **common)
        np.testing.assert_array_equal(np.asarray(ids_c), np.asarray(ids_p))
        np.testing.assert_allclose(np.asarray(d_c), np.asarray(d_p), rtol=1e-6)
    # Pruning branch: same equality with the 1.2x dynamic threshold on.
    pruned = dict(common, prune=True)
    ids_pp, d_pp = _search_kernel(
        q, view.centroids, view.cent_valid, view.offsets, view.lens,
        view.ids, view.vectors, view.scales, jnp.float32(1.2), **pruned)
    ids_cp, d_cp = _search_kernel_probe_chunked(
        q, view.centroids, view.cent_valid, view.offsets, view.lens,
        view.ids, view.vectors, view.scales, jnp.float32(1.2),
        probe_chunk=3, **pruned)
    np.testing.assert_array_equal(np.asarray(ids_cp), np.asarray(ids_pp))


def test_vectors_for_uses_id_map(tmp_path, rng):
    data = rng.standard_normal((150, 6)).astype(np.float32)
    cfg = _toy_config(tmp_path, clustering_params={"desired_cluster_size": 25})
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    got = index._vectors_for([3, 77, 149, 999_999])
    assert set(got) == {3, 77, 149}  # unknown id simply absent
    for pid, v in got.items():
        np.testing.assert_allclose(v, data[pid], rtol=1e-6)
    # Map survives (and refreshes across) an update.
    index.replace_posting(
        next(iter(index.postings)),
        np.array([500_000]),
        data[:1] * 0 + 7.0,
    )
    got2 = index._vectors_for([500_000])
    np.testing.assert_allclose(got2[500_000], np.full(6, 7.0), rtol=1e-6)


def test_hbm_guard_drops_corpus_cache(tmp_path, rng):
    import jax.numpy as jnp

    data = rng.standard_normal((60, 4)).astype(np.float32)
    cfg = _toy_config(tmp_path, clustering_params={"desired_cluster_size": 15})
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    assert index._corpus_cache is not None
    corpus_bytes = int(index._corpus_cache[1].size) * index._corpus_cache[1].dtype.itemsize
    index._hbm_guard(view_bytes=100, budget=corpus_bytes + 1000)  # fits
    assert index._corpus_cache is not None
    index._hbm_guard(view_bytes=2000, budget=corpus_bytes + 1000)  # crowds
    assert index._corpus_cache is None
    index._hbm_guard(view_bytes=10, budget=1)  # no-op when already dropped


def test_id_width_guard_rejects_int32_overflow():
    from spfresh_tpu.index.spann import _ids_i32

    ok = _ids_i32(np.array([0, 5, 2**31 - 2], np.int64))
    assert ok.dtype == np.int32
    with pytest.raises(ValueError):
        _ids_i32(np.array([2**31], np.int64))
    with pytest.raises(ValueError):
        _ids_i32(np.array([-2], np.int64))


def test_bf16_wire_build_deterministic_and_exact_on_rounded_corpus(tmp_path, rng):
    import ml_dtypes

    data = rng.standard_normal((200, 8)).astype(np.float32)
    base = _toy_config(tmp_path, clustering_params={"desired_cluster_size": 40})
    cfg = Config.from_dict({**base.to_dict(), "storage_dtype": "bfloat16"})
    q = rng.standard_normal((6, 8)).astype(np.float32)
    i1 = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    i2 = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    ids1, d1 = i1.search(q, k=5, nprobe=i1.num_clusters)
    ids2, d2 = i2.search(q, k=5, nprobe=i2.num_clusters)
    np.testing.assert_array_equal(ids1, ids2)  # same seed => same index
    # Full probe is exact against the corpus THE INDEX STORES: the bf16 wire
    # means it serves bf16-rounded vectors (same rounding class as bf16
    # storage always had).
    rounded = data.astype(ml_dtypes.bfloat16).astype(np.float32)
    gt_d, gt_i = brute_force_search(rounded, q, k=5)
    rec = np.mean([len(set(ids1[i]) & set(gt_i[i])) / 5 for i in range(6)])
    assert rec == 1.0


def test_bf16_query_wire_matches_rounded_f32_wire(tmp_path, rng):
    """search.query_wire="bfloat16" halves the per-batch query upload; the
    kernels upcast on device, so it must be EXACTLY the f32 wire evaluated
    at bf16-rounded query coordinates — on both engines."""
    import ml_dtypes

    data = rng.standard_normal((200, 16)).astype(np.float32)
    base = _toy_config(tmp_path, clustering_params={"desired_cluster_size": 40})
    wire = Config.from_dict(
        {**base.to_dict(), "search": {"query_wire": "bfloat16"}}
    )
    assert wire.search.query_wire == "bfloat16"  # survives dict roundtrip
    i_plain = SpannIndexBuilder(base).with_data(data).build(save=False)
    i_wire = SpannIndexBuilder(wire).with_data(data).build(save=False)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    q_rounded = q.astype(ml_dtypes.bfloat16).astype(np.float32)
    for engine in ("csr", "slab"):
        ids_w, d_w = i_wire.search(q, k=5, nprobe=i_wire.num_clusters, engine=engine)
        ids_r, d_r = i_plain.search(
            q_rounded, k=5, nprobe=i_plain.num_clusters, engine=engine
        )
        np.testing.assert_array_equal(ids_w, ids_r)
        np.testing.assert_allclose(d_w, d_r, rtol=1e-6)
    with pytest.raises(ValueError):
        Config.from_dict({**base.to_dict(), "search": {"query_wire": "fp8"}})


def test_int8_query_wire_matches_dequantized_f32_wire(tmp_path, rng):
    """search.query_wire="int8" ships per-query max-abs codes + one f32
    scale (~1/4 of the f32 wire bytes — the 960-d serve path is
    query-wire-bound) and dequantizes inside the search jit; it must be
    EXACTLY the f32 wire evaluated at the dequantized coordinates — on
    both engines."""
    data = rng.standard_normal((200, 16)).astype(np.float32)
    base = _toy_config(tmp_path, clustering_params={"desired_cluster_size": 40})
    wire = Config.from_dict(
        {**base.to_dict(), "search": {"query_wire": "int8"}}
    )
    assert wire.search.query_wire == "int8"  # survives dict roundtrip
    i_plain = SpannIndexBuilder(base).with_data(data).build(save=False)
    i_wire = SpannIndexBuilder(wire).with_data(data).build(save=False)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    s = np.maximum(np.abs(q).max(axis=1, keepdims=True), 1e-30) / 127.0
    q_deq = np.clip(np.rint(q / s), -127, 127).astype(np.float32) * s
    q_deq = q_deq.astype(np.float32)
    for engine in ("csr", "slab"):
        ids_w, d_w = i_wire.search(q, k=5, nprobe=i_wire.num_clusters, engine=engine)
        ids_r, d_r = i_plain.search(
            q_deq, k=5, nprobe=i_plain.num_clusters, engine=engine
        )
        np.testing.assert_array_equal(ids_w, ids_r)
        np.testing.assert_allclose(d_w, d_r, rtol=1e-6)
    # Full-probe recall vs ground truth AT the dequantized queries is 1.0
    # (the standing exactness framing for every reduced wire).
    gt_d, gt_i = brute_force_search(data, q_deq, k=5)
    ids_w, _ = i_wire.search(q, k=5, nprobe=i_wire.num_clusters)
    rec = np.mean([len(set(ids_w[i]) & set(gt_i[i])) / 5 for i in range(6)])
    assert rec == 1.0


def test_csr_engine_does_not_materialize_padded_view(tmp_path, rng):
    """A search on the CSR engine builds only the CSR device view: packing
    the slab view as well would hold a second copy of every posting on the
    device."""
    data = rng.standard_normal((600, 16)).astype(np.float32)
    cfg = Config.from_dict(
        {
            "clustering_params": {"desired_cluster_size": 30, "rng_seed": 1},
            "output_path": str(tmp_path / "idx"),
        }
    )
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    index.search(data[:4], 5, nprobe=index.num_clusters, engine="csr")
    assert index._padded_view is None
    index.search(data[:4], 5, nprobe=index.num_clusters, engine="slab")
    assert index._padded_view is not None


def test_slab_engine_exact_after_posting_shrinks(tmp_path, rng):
    """After deletes shrink the largest posting, the updated slab view keeps
    its old pad; full-probe slab search must still equal the CSR engine."""
    data = rng.standard_normal((400, 16)).astype(np.float32)
    cfg = Config.from_dict(
        {
            "clustering_params": {"desired_cluster_size": 40, "rng_seed": 3},
            "output_path": str(tmp_path / "idx"),
        }
    )
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    pad0 = index.padded_view().pad
    c = max(index.postings, key=lambda c: len(index.postings[c][0]))
    ids, vecs = index.postings[c]
    index.replace_posting(c, ids[:2], vecs[:2])
    assert index.padded_view().pad >= pad0 - index.config.search.slab_growth_slots
    q = data[:16]
    ids_s, d_s = index.search(q, 5, nprobe=index.num_clusters, engine="slab")
    ids_c, d_c = index.search(q, 5, nprobe=index.num_clusters, engine="csr")
    np.testing.assert_array_equal(ids_s, ids_c)
    np.testing.assert_allclose(d_s, d_c, rtol=1e-6)


def test_config_rejects_unknown_keys():
    """Typo'd keys/sections must raise, not silently build a default index
    (a 'clustering' section produced an UNSEEDED default-cap build)."""
    from spfresh_tpu.index.config import Config

    with pytest.raises(ValueError, match="unknown config key"):
        Config.from_dict({"clustering": {"rng_seed": 1}})
    with pytest.raises(ValueError, match="unknown config key"):
        Config.from_dict({"index_directory": "/tmp/x"})
    with pytest.raises(ValueError, match="unknown clustering_params key"):
        Config.from_dict({"clustering_params": {"seed": 1}})
    with pytest.raises(ValueError, match="unknown search key"):
        Config.from_dict({"search": {"n_probe": 8}})
    Config.from_dict({"clustering_params": {"rng_seed": 1}})  # valid: fine
