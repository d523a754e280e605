"""Sharded index build on the virtual 8-device CPU mesh: the mesh path
(assign + medoid via collectives, sharded multi-way subdivision) must produce
the same clustering as the single-device path, and a full sharded build must
search correctly."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from spfresh_tpu.clustering.hierarchical import (
    ClusteringParams,
    HierarchicalClustering,
    _split_level_multiway,
)
from spfresh_tpu.index import Config, SpannIndex, brute_force_search
from spfresh_tpu.parallel.build import sharded_split_level


def _mesh(n=8):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("shard",))


def _params(**kw):
    kw.setdefault("metric", "Euclidean")
    kw.setdefault("initialization_method", "KMeans++")
    kw.setdefault("initial_k", 4)
    kw.setdefault("rng_seed", 42)
    kw.setdefault("desired_cluster_size", 32)
    return ClusteringParams(**kw)


def test_sharded_split_level_matches_single_device(rng):
    import jax.numpy as jnp

    n, d, S, M = 512, 16, 8, 8
    X = rng.standard_normal((n, d)).astype(np.float32)
    # Two segments of unequal size spanning shard boundaries.
    point_list = np.zeros(n, np.int32)
    point_list[:n] = rng.permutation(n)
    cluster_of = (np.arange(n) >= 200).astype(np.int32)
    valid = np.ones(n, bool)
    c1_idx = np.zeros(S, np.int32)
    c1_idx[0] = point_list[0]
    c1_idx[1] = point_list[200]
    seed_valid = np.zeros((S, M), bool)
    seed_valid[0, :5] = True
    seed_valid[1, :3] = True

    Xj = jnp.asarray(X)
    a1, s1, c1, d1 = _split_level_multiway(
        Xj, jnp.asarray(point_list), jnp.asarray(cluster_of),
        jnp.int32(n), jnp.asarray(c1_idx), jnp.asarray(seed_valid),
        "Euclidean", num_segments=S, m_ways=M,
    )
    mesh = _mesh()
    from spfresh_tpu.parallel.cluster_step import replicate

    a2, s2, c2, d2 = sharded_split_level(
        mesh, replicate(mesh, X), point_list, cluster_of, valid,
        c1_idx, seed_valid, "Euclidean", num_segments=S, m_ways=M,
    )
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-6)


def test_sharded_fit_matches_single_device(rng):
    X = rng.standard_normal((400, 16)).astype(np.float32)
    hc1 = HierarchicalClustering(_params(), X).fit()
    hc2 = HierarchicalClustering(_params(), X, mesh=_mesh()).fit()
    assert len(hc1.clusters) == len(hc2.clusters)
    key1 = sorted((c.centroid_idx, tuple(c.points.tolist())) for c in hc1.clusters)
    key2 = sorted((c.centroid_idx, tuple(c.points.tolist())) for c in hc2.clusters)
    assert key1 == key2


def test_sharded_fit_uneven_n(rng):
    """n not divisible by the mesh size: padding rows must not leak into any
    cluster or win a medoid."""
    X = rng.standard_normal((403, 8)).astype(np.float32)
    hc = HierarchicalClustering(_params(initial_k=3), X, mesh=_mesh()).fit()
    all_pts = np.concatenate([c.points for c in hc.clusters])
    assert all_pts.min() >= 0 and all_pts.max() < 403
    assert set(all_pts.tolist()) == set(range(403))  # every point placed
    for c in hc.clusters:
        assert 0 <= c.centroid_idx < 403


def test_sharded_build_end_to_end_search(rng, tmp_path):
    """Full build over the mesh -> single-chip index -> full-probe search is
    exact (the standing recall-1.0 invariant)."""
    X = rng.standard_normal((320, 24)).astype(np.float32)
    params = _params(desired_cluster_size=40)
    hc = HierarchicalClustering(params, X, mesh=_mesh()).fit()
    cfg = Config.from_dict({"output_path": str(tmp_path / "idx")})
    index = SpannIndex(cfg)
    index.create_posting_lists(hc.clusters, X)
    q = rng.standard_normal((8, 24)).astype(np.float32)
    ids, _ = index.search(q, k=10, nprobe=index.num_clusters, engine="csr")
    _, gt = brute_force_search(X, q, k=10)
    for r in range(8):
        assert set(ids[r].tolist()) == set(gt[r].tolist())


def test_sharded_replica_pass_matches_single_device(rng):
    """The mesh replica pass (pure data parallelism) must return exactly the
    single-device _final_replica_pass results on every shard's slice."""
    import jax.numpy as jnp

    from spfresh_tpu.clustering.hierarchical import _final_replica_pass
    from spfresh_tpu.parallel import replicate, shard_rows, sharded_replica_pass

    X = rng.standard_normal((64, 6)).astype(np.float32)
    C = rng.standard_normal((9, 6)).astype(np.float32)
    base = rng.integers(0, 9, 64).astype(np.int32)
    mesh = _mesh()
    idx_s, d_s = sharded_replica_pass(
        mesh, shard_rows(mesh, X), shard_rows(mesh, base),
        replicate(mesh, C), "Euclidean", 1.3, 4,
    )
    idx_1, d_1 = _final_replica_pass(
        jnp.asarray(X), jnp.asarray(base), jnp.asarray(C),
        "Euclidean", jnp.float32(1.3), 4,
    )
    np.testing.assert_array_equal(np.asarray(idx_s), np.asarray(idx_1))
    finite = np.isfinite(np.asarray(d_1))
    np.testing.assert_allclose(
        np.asarray(d_s)[finite], np.asarray(d_1)[finite], rtol=1e-6
    )
    assert np.array_equal(finite, np.isfinite(np.asarray(d_s)))


def test_fit_device_levels_match_host_levels(rng, monkeypatch):
    """Small builds take the HOST tail-level path by default; forcing every
    level through the device kernel (and the mesh kernel) must produce the
    same clusters — guards the fit() wiring of all three split paths."""
    import spfresh_tpu.clustering.hierarchical as H

    X = rng.standard_normal((600, 8)).astype(np.float32)
    hc_host = H.HierarchicalClustering(_params(), X).fit()
    monkeypatch.setattr(H, "_HOST_SPLIT_MAX_P", 0)
    hc_dev = H.HierarchicalClustering(_params(), X).fit()
    hc_mesh = H.HierarchicalClustering(_params(), X, mesh=_mesh()).fit()

    def key(hc):
        return sorted(
            (c.centroid_idx, tuple(c.points.tolist())) for c in hc.clusters
        )

    assert key(hc_host) == key(hc_dev)
    assert key(hc_dev) == key(hc_mesh)


def test_sharded_fit_bf16_wire_matches_single_device(rng):
    """bf16 corpus wire (auto-enabled for bfloat16-storage configs) must be
    applied IDENTICALLY on the mesh and single-device paths — a mesh build
    of the same config + seed must produce the same clusters (ADVICE r2)."""
    X = rng.standard_normal((400, 16)).astype(np.float32)
    p1 = _params(wire_dtype="bfloat16")
    p2 = _params(wire_dtype="bfloat16")
    hc1 = HierarchicalClustering(p1, X).fit()
    hc2 = HierarchicalClustering(p2, X, mesh=_mesh()).fit()
    key1 = sorted((c.centroid_idx, tuple(c.points.tolist())) for c in hc1.clusters)
    key2 = sorted((c.centroid_idx, tuple(c.points.tolist())) for c in hc2.clusters)
    assert key1 == key2
    # And the rounding actually happened (host mirror carries bf16 grid).
    import ml_dtypes

    assert np.array_equal(
        hc2._host_data, X.astype(ml_dtypes.bfloat16).astype(np.float32)
    )


def test_builder_facade_mesh_build_matches_single_device(rng, tmp_path):
    """VERDICT r2 item 2: the mesh build must be reachable from the public
    facade — SpannIndexBuilder(cfg, mesh=...) over the 8-device CPU mesh
    builds the SAME index (postings + centroids) as the single-device
    builder."""
    from spfresh_tpu.index import SpannIndexBuilder

    X = rng.standard_normal((500, 24)).astype(np.float32)
    cfg = {
        "clustering_params": {
            "initial_k": 4,
            "desired_cluster_size": 40,
            "rng_seed": 11,
            "initialization_method": "KMeans++",
        },
        "output_path": str(tmp_path / "idx"),
    }
    idx1 = (
        SpannIndexBuilder(Config.from_dict(cfg)).with_data(X).build(save=False)
    )
    idx2 = (
        SpannIndexBuilder(Config.from_dict(cfg), mesh=_mesh())
        .with_data(X)
        .build(save=False)
    )
    assert sorted(idx1.postings) == sorted(idx2.postings)
    for c in idx1.postings:
        np.testing.assert_array_equal(idx1.postings[c][0], idx2.postings[c][0])
        np.testing.assert_array_equal(
            np.asarray(idx1.postings[c][1]), np.asarray(idx2.postings[c][1])
        )
        np.testing.assert_array_equal(idx1.centroids[c], idx2.centroids[c])
    # The mesh builder's corpus handoff must let the view pack run on-chip
    # and search must agree between the two indexes.
    q = rng.standard_normal((6, 24)).astype(np.float32)
    i1, d1 = idx1.search(q, k=5, nprobe=idx1.num_clusters, engine="csr")
    i2, d2 = idx2.search(q, k=5, nprobe=idx2.num_clusters, engine="csr")
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)


def test_builder_mesh_resolution(rng):
    """mesh=None -> single device; mesh=1 -> single device; explicit Mesh
    object passes through; 'auto' never grabs virtual CPU devices."""
    from spfresh_tpu.index.builder import _resolve_mesh

    assert _resolve_mesh(None) is None
    assert _resolve_mesh(1) is None
    assert _resolve_mesh("auto") is None  # CPU platform in tests
    m = _mesh(4)
    assert _resolve_mesh(m) is m
    assert _resolve_mesh(4).devices.size == 4
    with pytest.raises(ValueError):
        _resolve_mesh(1000)


def test_rowsharded_corpus_memory_and_equality(rng):
    """VERDICT r2 item 3: the mesh build's default layout keeps n/S corpus
    rows per chip — no device holds the full corpus — and the clustering is
    still bit-identical to single-device."""
    from jax.sharding import PartitionSpec

    n, d = 403, 16  # uneven n exercises mesh padding
    X = rng.standard_normal((n, d)).astype(np.float32)
    mesh = _mesh()
    hc1 = HierarchicalClustering(_params(initial_k=3), X).fit()
    hc2 = HierarchicalClustering(_params(initial_k=3), X, mesh=mesh).fit()
    assert hc2._corpus_layout == "sharded"
    S = mesh.devices.size
    n_pad = ((n + S - 1) // S) * S
    assert hc2.data.shape[0] == n_pad
    # Row-sharded: every addressable shard holds exactly n_pad/S rows.
    assert hc2.data.sharding.spec == PartitionSpec("shard")
    for sh in hc2.data.addressable_shards:
        assert sh.data.shape == (n_pad // S, d)
    key1 = sorted((c.centroid_idx, tuple(c.points.tolist())) for c in hc1.clusters)
    key2 = sorted((c.centroid_idx, tuple(c.points.tolist())) for c in hc2.clusters)
    assert key1 == key2


def test_replicated_corpus_layout_still_matches(rng):
    """The opt-in replicated layout (zero-upload view-pack handoff) remains
    bit-identical to both single-device and the sharded layout."""
    X = rng.standard_normal((400, 16)).astype(np.float32)
    hc1 = HierarchicalClustering(_params(), X).fit()
    hc2 = HierarchicalClustering(
        _params(), X, mesh=_mesh(), corpus_layout="replicated"
    ).fit()
    key1 = sorted((c.centroid_idx, tuple(c.points.tolist())) for c in hc1.clusters)
    key2 = sorted((c.centroid_idx, tuple(c.points.tolist())) for c in hc2.clusters)
    assert key1 == key2


def test_kmeanspp_sharded_matches_single_device(rng):
    """Sharded KMeans++ must reproduce the single-device seeding draw for
    draw: same folded keys, same (n,) logits, same categorical winner."""
    import jax
    import jax.numpy as jnp

    from spfresh_tpu.clustering.hierarchical import _kmeanspp_init
    from spfresh_tpu.parallel.build import kmeanspp_init_sharded
    from spfresh_tpu.parallel.cluster_step import shard_rows

    n, d, k = 203, 12, 7  # uneven n: padded rows must never be drawn
    X = rng.standard_normal((n, d)).astype(np.float32)
    key = jax.random.key(99)
    single = np.asarray(_kmeanspp_init(key, jnp.asarray(X), k, "Euclidean"))
    mesh = _mesh()
    S = mesh.devices.size
    n_pad = ((n + S - 1) // S) * S
    Xp = np.concatenate([X, np.repeat(X[:1], n_pad - n, axis=0)])
    sharded = np.asarray(
        kmeanspp_init_sharded(
            mesh, key, shard_rows(mesh, Xp), k, "Euclidean", n
        )
    )
    np.testing.assert_array_equal(single, sharded)
    assert (sharded < n).all()


def test_rowsharded_split_level_matches_single_device(rng):
    import jax.numpy as jnp

    from spfresh_tpu.parallel.build import sharded_split_level_rows
    from spfresh_tpu.parallel.cluster_step import shard_rows

    n, d, S, M = 509, 16, 8, 8  # uneven n
    X = rng.standard_normal((n, d)).astype(np.float32)
    flat_members = rng.permutation(n)[:400].astype(np.int64)
    cluster_of = (np.arange(400) >= 150).astype(np.int32)
    c1_idx = np.zeros(S, np.int32)
    c1_idx[0] = flat_members[0]
    c1_idx[1] = flat_members[150]
    seed_valid = np.zeros((S, M), bool)
    seed_valid[0, :5] = True
    seed_valid[1, :3] = True

    P = 400
    Ppad = 512
    pl = np.zeros(Ppad, np.int32)
    pl[:P] = flat_members
    co = np.zeros(Ppad, np.int32)
    co[:P] = cluster_of
    vl = np.zeros(Ppad, bool)
    vl[:P] = True
    from spfresh_tpu.clustering.hierarchical import _split_level_multiway

    a1, s1, c1, d1 = _split_level_multiway(
        jnp.asarray(X), jnp.asarray(pl), jnp.asarray(co), jnp.int32(P),
        jnp.asarray(c1_idx), jnp.asarray(seed_valid), "Euclidean",
        num_segments=S, m_ways=M,
    )
    mesh = _mesh()
    Ssh = mesh.devices.size
    n_pad = ((n + Ssh - 1) // Ssh) * Ssh
    Xp = np.concatenate([X, np.repeat(X[:1], n_pad - n, axis=0)])
    a2, s2, c2, d2 = sharded_split_level_rows(
        mesh, shard_rows(mesh, Xp), flat_members, cluster_of,
        c1_idx, seed_valid, "Euclidean", num_segments=S, m_ways=M,
    )
    np.testing.assert_array_equal(np.asarray(s1), s2)
    np.testing.assert_array_equal(np.asarray(a1)[:P], a2)
    np.testing.assert_array_equal(np.asarray(c1), c2)
    np.testing.assert_allclose(np.asarray(d1)[:P], d2, rtol=1e-6)


def test_sharded_layout_never_replicates_corpus(rng, monkeypatch):
    """'Corpus > 1-chip budget' proxy: through an entire sharded-layout
    build, nothing corpus-sized is ever replicated to a device — only
    centroid-sized arrays (C, d) may replicate; every (n, d) placement is
    row-sharded."""
    import spfresh_tpu.parallel.cluster_step as cs

    n, d = 480, 16
    X = rng.standard_normal((n, d)).astype(np.float32)
    replicated_shapes = []
    orig = cs.replicate

    def spy(mesh, x, *a, **kw):
        replicated_shapes.append(np.asarray(x).shape)
        return orig(mesh, x, *a, **kw)

    monkeypatch.setattr(cs, "replicate", spy)
    hc = HierarchicalClustering(
        _params(initial_k=4, desired_cluster_size=30), X, mesh=_mesh()
    ).fit()
    assert hc._corpus_layout == "sharded"
    n_rows_replicated = max((s[0] for s in replicated_shapes), default=0)
    assert n_rows_replicated < n, (
        f"corpus-sized array replicated: {replicated_shapes}"
    )
    # And the build is still correct end-to-end.
    assert sum(len(c) for c in hc.clusters) >= n


# ---------------------------------------------------------------------------
# Mesh-resident subdivision (round-4 lever 5): the per-point assignment
# vector lives SHARDED across levels; bit-equality with single-device
# ---------------------------------------------------------------------------


def _snap(hc):
    return [(c.centroid_idx, c.depth, c.points.tolist()) for c in hc.clusters]


def _mesh_resident_fit(monkeypatch, data, params_kw, host_tail_max,
                       expect_resident=True):
    """Single-device (default paths) vs mesh-resident fit of the same
    corpus; asserts the mesh resident driver actually ran."""
    import spfresh_tpu.clustering.hierarchical as H
    import spfresh_tpu.parallel.build as PB

    hc_ref = H.HierarchicalClustering(_params(**params_kw), data).fit()
    monkeypatch.setattr(H, "_HOST_SPLIT_MAX_P", host_tail_max)
    monkeypatch.setenv("SPF_SUBDIV_RESIDENT", "1")
    calls = {"n": 0}
    real = PB._resident_split_call

    def spy(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(PB, "_resident_split_call", spy)
    hc_mesh = H.HierarchicalClustering(
        _params(**params_kw), data, mesh=_mesh()
    ).fit()
    assert hc_mesh._corpus_layout == "sharded"
    if expect_resident:
        assert calls["n"] > 0, "mesh resident kernel never ran"
    return hc_ref, hc_mesh


def test_mesh_resident_fit_matches_single_device(monkeypatch, rng):
    centers = rng.standard_normal((6, 12)).astype(np.float32)
    data = (
        centers[rng.integers(0, 6, 3000)]
        + 0.3 * rng.standard_normal((3000, 12))
    ).astype(np.float32)
    hc_ref, hc_mesh = _mesh_resident_fit(
        monkeypatch, data,
        dict(initial_k=4, desired_cluster_size=40, max_split_ways=8,
             rng_seed=7),
        host_tail_max=0,  # every level through the resident mesh kernel
    )
    assert _snap(hc_ref) == _snap(hc_mesh)


def test_mesh_resident_handoff_to_host_tail_matches(monkeypatch, rng):
    """Resident mesh big levels + shared host tail must continue the SAME
    per-level Philox stream (level-counter continuity across the handoff)."""
    centers = rng.standard_normal((5, 8)).astype(np.float32)
    data = (
        centers[rng.integers(0, 5, 2400)]
        + 0.5 * rng.standard_normal((2400, 8))
    ).astype(np.float32)
    hc_ref, hc_mesh = _mesh_resident_fit(
        monkeypatch, data,
        dict(initial_k=3, desired_cluster_size=30, max_split_ways=4,
             rng_seed=11),
        host_tail_max=600,
    )
    assert _snap(hc_ref) == _snap(hc_mesh)


def test_mesh_resident_degenerate_duplicates_match(monkeypatch, rng):
    """Duplicate-heavy clusters hit the degenerate quantile branch: the
    mesh driver's park-at-parent + pull + host quantile fix must reproduce
    the single-device numbering, seeds and membership exactly."""
    base = rng.standard_normal((4, 6)).astype(np.float32)
    data = np.repeat(base, 300, axis=0)  # 1200 rows, only 4 distinct
    hc_ref, hc_mesh = _mesh_resident_fit(
        monkeypatch, data,
        dict(initial_k=2, desired_cluster_size=50, max_split_ways=4,
             rng_seed=3),
        host_tail_max=0,
    )
    assert _snap(hc_ref) == _snap(hc_mesh)


def test_mesh_resident_uneven_n_matches(monkeypatch, rng):
    """n not divisible by the mesh: corpus padding rows must never join a
    segment, win a seed, or survive into any cluster."""
    centers = rng.standard_normal((4, 8)).astype(np.float32)
    data = (
        centers[rng.integers(0, 4, 1603)]
        + 0.4 * rng.standard_normal((1603, 8))
    ).astype(np.float32)
    hc_ref, hc_mesh = _mesh_resident_fit(
        monkeypatch, data,
        dict(initial_k=3, desired_cluster_size=60, max_split_ways=4,
             rng_seed=5),
        host_tail_max=0,
    )
    assert _snap(hc_ref) == _snap(hc_mesh)
    all_pts = np.concatenate([c.points for c in hc_mesh.clusters])
    assert set(all_pts.tolist()) == set(range(1603))


def test_mesh_resident_mixed_degenerate_and_normal_level(monkeypatch, rng):
    """A level where SOME segments are degenerate (all duplicates) and others
    split normally: the degenerate branch reserves child ids inline, so the
    interleaved id numbering must still match the single-device drivers."""
    centers = rng.standard_normal((3, 6)).astype(np.float32)
    normal = (
        centers[rng.integers(0, 3, 700)]
        + 0.4 * rng.standard_normal((700, 6))
    ).astype(np.float32)
    dupes = np.repeat(rng.standard_normal((2, 6)).astype(np.float32), 350, axis=0)
    # Interleave so duplicate blocks and spread points share initial clusters.
    data = np.concatenate([normal, dupes])
    perm = rng.permutation(len(data))
    data = data[perm]
    hc_ref, hc_mesh = _mesh_resident_fit(
        monkeypatch, data,
        dict(initial_k=2, desired_cluster_size=60, max_split_ways=4,
             rng_seed=13),
        host_tail_max=0,
    )
    assert _snap(hc_ref) == _snap(hc_mesh)
