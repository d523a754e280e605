"""Clustering engine tests — mirrors the reference's inline suite
(/root/reference/src/clustering/hierarchical.rs:393-509, utils.rs:17-34):
seeded determinism, k seeded clusters, subdivision caps sizes, assignment
covers all points, full fit on the 6x2 three-pair dataset."""

import numpy as np
import pytest

from spfresh_tpu.clustering import (
    Cluster,
    ClusteringParams,
    HierarchicalClustering,
    compute_mean,
)
from spfresh_tpu.ops import EUCLIDEAN, MANHATTAN


def test_compute_mean():
    data = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], np.float32)
    m = np.asarray(compute_mean(data, np.array([0, 2])))
    np.testing.assert_allclose(m, [3.0, 4.0])


def _params(**kw):
    defaults = dict(metric=EUCLIDEAN, initialization_method="Random", initial_k=3, rng_seed=42)
    defaults.update(kw)
    return ClusteringParams(**defaults)


def test_random_init_produces_k_clusters(toy_data):
    hc = HierarchicalClustering(_params(initial_k=3), toy_data)
    hc._initialize_clusters(3)
    assert len(hc.clusters) == 3
    idxs = [c.centroid_idx for c in hc.clusters]
    assert len(set(idxs)) == 3  # distinct seeds (choose without replacement)
    assert all(0 <= i < 6 for i in idxs)


def test_kmeanspp_init_produces_k_clusters(toy_data):
    hc = HierarchicalClustering(
        _params(initialization_method="KMeans++", initial_k=3), toy_data
    )
    hc._initialize_clusters(3)
    assert len(hc.clusters) == 3
    assert all(0 <= c.centroid_idx < 6 for c in hc.clusters)


def test_assignment_covers_all_points(toy_data):
    hc = HierarchicalClustering(_params(initial_k=3), toy_data)
    hc._initialize_clusters(3)
    hc._assign_points()
    assigned = np.concatenate([c.points for c in hc.clusters])
    assert set(assigned.tolist()) == set(range(6))


def test_fit_caps_cluster_sizes(toy_data):
    hc = HierarchicalClustering(
        _params(initial_k=3, desired_cluster_size=2), toy_data
    ).fit()
    assert all(len(c) <= 2 for c in hc.clusters)
    assigned = set(np.concatenate([c.points for c in hc.clusters]).tolist())
    assert assigned == set(range(6))


def test_fit_deterministic_under_seed(toy_data):
    def run():
        hc = HierarchicalClustering(
            _params(initial_k=3, desired_cluster_size=2), toy_data
        ).fit()
        return [(c.centroid_idx, tuple(c.points.tolist())) for c in hc.clusters]

    assert run() == run()


def test_fit_pairs_cluster_together(toy_data):
    # The three well-separated pairs should each land in one cluster.
    hc = HierarchicalClustering(
        _params(initial_k=3, desired_cluster_size=2, rng_seed=7), toy_data
    ).fit()
    labels = hc.labels()
    assert labels[0] == labels[1]
    assert labels[2] == labels[3]
    assert labels[4] == labels[5]
    assert len({labels[0], labels[2], labels[4]}) == 3


def test_subdivision_on_larger_data(rng):
    # max_replicas=1 -> no replica pass: strict size caps must hold.
    data = rng.standard_normal((200, 8)).astype(np.float32)
    hc = HierarchicalClustering(
        _params(initial_k=2, desired_cluster_size=20, max_replicas=1), data
    ).fit()
    assert all(len(c) <= 20 for c in hc.clusters)
    assigned = set(np.concatenate([c.points for c in hc.clusters]).tolist())
    assert assigned == set(range(200))
    # Every cluster's centroid is one of its own members (SPANN medoid rule),
    # except empty clusters which keep their seed.
    for c in hc.clusters:
        if len(c):
            assert c.centroid_idx in set(c.points.tolist())


def test_final_replication_bounded(rng):
    data = rng.standard_normal((300, 8)).astype(np.float32)
    hc = HierarchicalClustering(
        _params(initial_k=2, desired_cluster_size=30, max_replicas=4), data
    ).fit()
    total = sum(len(c) for c in hc.clusters)
    assert 300 <= total <= 300 * 4  # replication bounded by max_replicas
    # Base membership is intact: every point appears somewhere.
    assigned = set(np.concatenate([c.points for c in hc.clusters]).tolist())
    assert assigned == set(range(300))
    # Replicas only modestly exceed the cap (bounded by the replica pass).
    assert max(len(c) for c in hc.clusters) <= 30 * 4


def test_nested_replication_reference_parity(rng):
    # 'nested' mode: the reference's in-split closure; caps hold including
    # replicas (subdivision re-checks sizes after replication).
    data = rng.standard_normal((200, 8)).astype(np.float32)
    hc = HierarchicalClustering(
        _params(initial_k=2, desired_cluster_size=25, replication="nested"), data
    ).fit()
    assert all(len(c) <= 25 for c in hc.clusters)
    assigned = set(np.concatenate([c.points for c in hc.clusters]).tolist())
    assert assigned == set(range(200))


def test_duplicate_points_terminate():
    # SURVEY.md quirk 6: all-identical oversized cluster must not loop forever.
    data = np.ones((32, 4), np.float32)
    hc = HierarchicalClustering(
        _params(initial_k=1, desired_cluster_size=4), data
    ).fit()
    assert all(len(c) <= 4 for c in hc.clusters)
    assigned = set(np.concatenate([c.points for c in hc.clusters]).tolist())
    assert assigned == set(range(32))


def test_manhattan_metric_clustering(toy_data):
    hc = HierarchicalClustering(
        _params(metric=MANHATTAN, initial_k=3, desired_cluster_size=2), toy_data
    ).fit()
    labels = hc.labels()
    assert labels[0] == labels[1]
    assert labels[2] == labels[3]


def test_labels_resolve_replicas(rng):
    data = rng.standard_normal((100, 4)).astype(np.float32)
    hc = HierarchicalClustering(
        _params(initial_k=4, desired_cluster_size=30), data
    ).fit()
    labels = hc.labels()
    assert labels.shape == (100,)
    # Each label points at a cluster that actually contains the point.
    member_sets = [set(c.points.tolist()) for c in hc.clusters]
    for p in range(100):
        assert p in member_sets[labels[p]]


def test_initial_k_validation(toy_data):
    with pytest.raises(ValueError):
        ClusteringParams(initial_k=0)
    with pytest.raises(ValueError):
        HierarchicalClustering(_params(initial_k=10), toy_data).fit()


def test_replica_pass_groups_match_one_call(rng):
    # Row groups of the closure pass (including a ragged last group) must
    # reproduce the one-call result exactly: every row depends only on its
    # own inputs.
    import jax.numpy as jnp

    from spfresh_tpu.clustering.hierarchical import _final_replica_pass

    n, d, C, n_extra = 333, 16, 37, 3  # n deliberately not a tile multiple
    X = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    cents = jnp.asarray(rng.standard_normal((C, d)).astype(np.float32))
    base = jnp.asarray(rng.integers(0, C, n).astype(np.int32))
    bt = jnp.float32(1.15)
    for metric in (EUCLIDEAN, MANHATTAN):
        tile = 128
        fi, fd = _final_replica_pass(X, base, cents, metric, bt, n_extra)
        oi_parts, od_parts = [], []
        for s in range(0, n, tile):
            oi, od = _final_replica_pass(
                X[s : s + tile], base[s : s + tile], cents, metric, bt, n_extra
            )
            oi_parts.append(np.asarray(oi))
            od_parts.append(np.asarray(od))
        oi = np.concatenate(oi_parts)
        od = np.concatenate(od_parts)
        valid = np.isfinite(od)
        np.testing.assert_array_equal(np.asarray(fi)[valid], oi[valid])
        np.testing.assert_allclose(np.asarray(fd), od, rtol=0, atol=0)


def test_replica_pass_dispatch_grouping_identical(monkeypatch, rng):
    # Elementwise metrics run the XLA closure pass in row groups bounded by
    # the (group, C) workspace.  Every output row depends only on its own
    # inputs, so a tiny forced workspace (many row groups) must reproduce
    # the single-group clustering EXACTLY.
    from spfresh_tpu.clustering import hierarchical as H

    data = rng.standard_normal((700, 24)).astype(np.float32)
    kw = dict(
        metric=MANHATTAN, initial_k=2, desired_cluster_size=60,
        max_replicas=4,
    )
    ref = HierarchicalClustering(_params(**kw), data).fit()
    # 256-row groups (the floor) instead of one group of all 700 rows.
    monkeypatch.setattr(H, "_REPLICA_WORKSPACE_ELEMS", 1)
    grouped = HierarchicalClustering(_params(**kw), data).fit()
    assert _clusters_snapshot(ref) == _clusters_snapshot(grouped)


# ---------------------------------------------------------------------------
# Device-resident subdivision (round 4): bit-equality with the upload path
# ---------------------------------------------------------------------------


def _clusters_snapshot(hc):
    return [
        (c.centroid_idx, c.depth, c.points.tolist()) for c in hc.clusters
    ]


def _fit_pair(monkeypatch, data, params_kw, host_tail_max):
    """Fit the same corpus with the resident path ON and OFF; return both."""
    import os

    from spfresh_tpu.clustering import hierarchical as H

    monkeypatch.setattr(H, "_HOST_SPLIT_MAX_P", host_tail_max)
    out = []
    for flag in ("1", "0"):
        monkeypatch.setenv("SPF_SUBDIV_RESIDENT", flag)
        hc = HierarchicalClustering(_params(**params_kw), data).fit()
        out.append(hc)
    return out


def test_resident_subdivision_matches_upload_path(monkeypatch, rng):
    centers = rng.standard_normal((6, 12)).astype(np.float32)
    data = (
        centers[rng.integers(0, 6, 3000)]
        + 0.3 * rng.standard_normal((3000, 12))
    ).astype(np.float32)
    res, classic = _fit_pair(
        monkeypatch, data,
        dict(initial_k=4, desired_cluster_size=40, max_split_ways=8,
             rng_seed=7),
        host_tail_max=0,  # force DEVICE levels end-to-end on both paths
    )
    assert _clusters_snapshot(res) == _clusters_snapshot(classic)


def test_resident_handoff_to_host_tail_matches(monkeypatch, rng):
    """Resident big levels + host tail must continue the SAME per-level
    Philox stream the pure path uses (level-counter continuity)."""
    centers = rng.standard_normal((5, 8)).astype(np.float32)
    data = (
        centers[rng.integers(0, 5, 2400)]
        + 0.5 * rng.standard_normal((2400, 8))
    ).astype(np.float32)
    res, classic = _fit_pair(
        monkeypatch, data,
        dict(initial_k=3, desired_cluster_size=30, max_split_ways=4,
             rng_seed=11),
        host_tail_max=600,  # early levels resident, tail on host
    )
    assert _clusters_snapshot(res) == _clusters_snapshot(classic)


def test_resident_degenerate_duplicates_match(monkeypatch, rng):
    """Duplicate-heavy clusters hit the degenerate quantile-split branch;
    the resident path's device d1 + host quantile fix-up must reproduce the
    upload path exactly."""
    base = rng.standard_normal((4, 6)).astype(np.float32)
    data = np.repeat(base, 300, axis=0)  # 1200 rows, only 4 distinct
    res, classic = _fit_pair(
        monkeypatch, data,
        dict(initial_k=2, desired_cluster_size=50, max_split_ways=4,
             rng_seed=3),
        host_tail_max=0,
    )
    assert _clusters_snapshot(res) == _clusters_snapshot(classic)


def test_resident_subdivision_manhattan_matches(monkeypatch, rng):
    centers = rng.standard_normal((4, 10)).astype(np.float32)
    data = (
        centers[rng.integers(0, 4, 1600)]
        + 0.4 * rng.standard_normal((1600, 10))
    ).astype(np.float32)
    res, classic = _fit_pair(
        monkeypatch, data,
        dict(metric=MANHATTAN, initial_k=3, desired_cluster_size=40,
             max_split_ways=4, rng_seed=5),
        host_tail_max=0,
    )
    assert _clusters_snapshot(res) == _clusters_snapshot(classic)


def test_resident_subdivision_with_empty_clusters(monkeypatch, rng):
    """Random init can seed duplicate-adjacent centroids whose assignment
    leaves clusters EMPTY; the resident bookkeeping must carry them."""
    base = rng.standard_normal((3, 6)).astype(np.float32)
    data = np.concatenate([
        np.repeat(base, 200, axis=0),  # heavy duplicates
        base[0] + 0.01 * rng.standard_normal((600, 6)).astype(np.float32),
    ]).astype(np.float32)
    res, classic = _fit_pair(
        monkeypatch, data,
        dict(initialization_method="Random", initial_k=12,
             desired_cluster_size=60, max_split_ways=4, rng_seed=9),
        host_tail_max=0,
    )
    assert _clusters_snapshot(res) == _clusters_snapshot(classic)


def test_resident_failure_fails_the_build(monkeypatch, rng):
    """A failure of the resident subdivision (compile or allocation on the
    device) fails the build: nothing swaps the failed route for the upload
    path."""
    from spfresh_tpu.clustering import hierarchical as H

    centers = rng.standard_normal((5, 10)).astype(np.float32)
    data = (
        centers[rng.integers(0, 5, 2000)]
        + 0.3 * rng.standard_normal((2000, 10))
    ).astype(np.float32)
    kw = dict(initial_k=3, desired_cluster_size=40, max_split_ways=4,
              rng_seed=21)
    monkeypatch.setattr(H, "_HOST_SPLIT_MAX_P", 0)

    def boom(self, cap, _p, level):
        raise RuntimeError("injected resident-path device failure")

    monkeypatch.setattr(H.HierarchicalClustering,
                        "_subdivide_multiway_resident", boom)
    monkeypatch.setenv("SPF_SUBDIV_RESIDENT", "1")
    with pytest.raises(RuntimeError, match="injected"):
        HierarchicalClustering(_params(**kw), data).fit()


def test_resident_count_drift_is_never_swallowed(monkeypatch, rng):
    """The ResidentCountDrift correctness sentinel propagates out of the
    build: a silent upload-path redo would hide a real kernel regression
    behind correct-but-doubled-cost builds."""
    from spfresh_tpu.clustering import hierarchical as H

    data = rng.standard_normal((1500, 8)).astype(np.float32)
    monkeypatch.setattr(H, "_HOST_SPLIT_MAX_P", 0)
    monkeypatch.setenv("SPF_SUBDIV_RESIDENT", "1")

    def drift(self, cap, _p, level):
        raise H.ResidentCountDrift("synthetic drift")

    monkeypatch.setattr(H.HierarchicalClustering,
                        "_subdivide_multiway_resident", drift)
    with pytest.raises(H.ResidentCountDrift):
        HierarchicalClustering(
            _params(initial_k=3, desired_cluster_size=40, rng_seed=1), data
        ).fit()


@pytest.mark.parametrize("metric", [EUCLIDEAN, MANHATTAN])
def test_fused_assign_medoid_bit_identical(metric):
    """The fused one-call assign+medoid round must reproduce the two-step
    `_assign_points()` + `_update_centroids()` exactly — points AND the
    updated medoid indices — including ties and empty clusters."""
    rng = np.random.default_rng(11)
    data = rng.standard_normal((400, 16)).astype(np.float32)
    # Duplicate a block of rows to force distance ties in both reductions.
    data[50:60] = data[0:10]
    p = _params(initial_k=7, metric=metric, rng_seed=9)

    a = HierarchicalClustering(p, data)
    a._initialize_clusters(7)
    a._assign_points()
    a._update_centroids()

    b = HierarchicalClustering(p, data)
    b._initialize_clusters(7)
    b._assign_and_update_fused()

    for ca, cb in zip(a.clusters, b.clusters):
        assert np.array_equal(ca.points, cb.points)
        assert ca.centroid_idx == cb.centroid_idx


def test_host_tail_threshold_scaling():
    """The host-tail boundary is 128/d-scaled on accelerators and flat on
    CPU (work placement only; both sides are bit-identical by the handoff
    equality tests)."""
    from spfresh_tpu.clustering.hierarchical import (
        _HOST_SPLIT_MAX_P,
        _tail_rows_for,
    )

    assert _tail_rows_for("cpu", 960) == _HOST_SPLIT_MAX_P
    assert _tail_rows_for("gpu", 128) == _HOST_SPLIT_MAX_P
    assert _tail_rows_for("gpu", 64) == _HOST_SPLIT_MAX_P  # never raises it
    assert _tail_rows_for("gpu", 960) == (_HOST_SPLIT_MAX_P * 128) // 960
    assert _tail_rows_for("gpu", 100_000) == 1 << 14  # floor
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        _tail_rows_for("rocm", 128)
