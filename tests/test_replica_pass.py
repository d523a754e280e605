"""The XLA closure-replica and assign passes against the float64
references of clustering/reference.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spfresh_tpu.clustering.hierarchical import _final_replica_pass
from spfresh_tpu.clustering.reference import (
    nearest_mismatches,
    replica_mismatches,
)


def _case(seed, n, C, d, dtype):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    cents = X[rng.integers(0, n, C)] + 0.1 * rng.standard_normal(
        (C, d)
    ).astype(np.float32)
    base = rng.integers(0, C, n).astype(np.int32)
    if dtype == "bfloat16":
        import ml_dtypes

        X = X.astype(ml_dtypes.bfloat16)
        cents = cents.astype(ml_dtypes.bfloat16)
    return jnp.asarray(X), jnp.asarray(base), jnp.asarray(cents)


def _check_against_reference(ki, kd, X, base, cents, bt, lam=0.0):
    bad = replica_mismatches(ki, kd, X, base, cents, bt, lam)
    assert not bad, f"rows {bad[:10]} break the closure rule"


@pytest.mark.parametrize(
    "n,C,d,ne,dtype",
    [
        (500, 37, 19, 3, "float32"),      # nothing aligned to a power of 2
        (300, 130, 64, 7, "float32"),
        (700, 600, 33, 1, "float32"),
        (256, 512, 128, 8, "float32"),
        (400, 50, 128, 3, "bfloat16"),
        (513, 700, 96, 4, "bfloat16"),
        (300, 200, 960, 4, "bfloat16"),   # GIST width
    ],
)
def test_replica_pass_matches_numpy_reference(n, C, d, ne, dtype):
    X, base, cents = _case(42, n, C, d, dtype)
    bt = 1.3
    ki, kd = _final_replica_pass(X, base, cents, "Euclidean", jnp.float32(bt), ne)
    _check_against_reference(ki, kd, X, base, cents, bt)


@pytest.mark.parametrize("lam", [0.5, 1.5])
def test_soar_matches_numpy_reference(lam):
    """SOAR ranking (D + lambda (r_j.r_1)^2/|r_1|^2) against the reference;
    lambda = 0 degenerates to the plain path bit-for-bit."""
    X, base, cents = _case(21, 450, 80, 32, "float32")
    bt = 1.4
    ki, kd = _final_replica_pass(
        X, base, cents, "Euclidean", jnp.float32(bt), 3, soar_lambda=lam
    )
    _check_against_reference(ki, kd, X, base, cents, bt, lam)
    i0, d0 = _final_replica_pass(X, base, cents, "Euclidean", jnp.float32(bt), 3)
    iz, dz = _final_replica_pass(
        X, base, cents, "Euclidean", jnp.float32(bt), 3, soar_lambda=0.0
    )
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(iz))
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(dz))


def test_soar_prefers_orthogonal_residual():
    """Two admitted candidates at EQUAL distance: plain ranking ties to the
    lower id; SOAR must pick the one whose residual is orthogonal to the
    primary residual regardless of id order."""
    d = 8
    x = np.zeros((1, d), np.float32)
    cents = np.zeros((3, d), np.float32)
    cents[0, 0] = 1.0                     # base: r1 = -e0, db = 1
    cents[1, 0] = -2.0                    # collinear candidate (id 1): D = 4
    cents[2, 1] = 2.0                     # orthogonal candidate (id 2): D = 4
    base = np.zeros(1, np.int32)
    args = (jnp.asarray(x), jnp.asarray(base), jnp.asarray(cents),
            "Euclidean", jnp.float32(10.0), 1)
    # bt admits both (D=4 < 10*1); closure holds: cc = 9 and 5, both >= 4.
    i_plain, _ = _final_replica_pass(*args)
    i_soar, _ = _final_replica_pass(*args, soar_lambda=1.0)
    assert int(np.asarray(i_plain)[0, 0]) == 1   # tie -> lower id
    assert int(np.asarray(i_soar)[0, 0]) == 2    # orthogonality wins


def test_duplicate_heavy_invariants():
    """Ties everywhere (8 distinct rows repeated): the pass must stay a
    valid closure pass — ascending distances, no duplicate ids per row,
    never the base id, eligibility holds in f64 up to f32 tie tolerance."""
    rng = np.random.default_rng(3)
    protos = rng.standard_normal((8, 24)).astype(np.float32)
    X = protos[rng.integers(0, 8, 320)]
    cents = protos[rng.integers(0, 8, 40)] * 1.01
    base = rng.integers(0, 40, 320).astype(np.int32)
    bt = 1.5
    ki, kd = _final_replica_pass(
        jnp.asarray(X), jnp.asarray(base), jnp.asarray(cents), "Euclidean",
        jnp.float32(bt), 4,
    )
    ki, kd = np.asarray(ki), np.asarray(kd)
    fin = np.isfinite(kd)
    with np.errstate(invalid="ignore"):
        assert np.all(np.diff(kd, axis=1)[fin[:, 1:]] >= 0)
    assert np.all(fin[:, :-1] | ~fin[:, 1:])
    Xd, Cd = X.astype(np.float64), np.asarray(cents, np.float64)
    for r in np.nonzero(fin.any(axis=1))[0][:64]:
        ids = ki[r][fin[r]]
        assert len(set(ids.tolist())) == len(ids)
        assert base[r] not in ids
        db = ((Xd[r] - Cd[base[r]]) ** 2).sum()
        for j, dv in zip(ids, kd[r][fin[r]]):
            dj = ((Xd[r] - Cd[j]) ** 2).sum()
            cc = ((Cd[base[r]] - Cd[j]) ** 2).sum()
            assert dj < bt * db * (1 + 1e-4) + 1e-4
            assert cc >= dj * (1 - 1e-4) - 1e-4
            assert abs(dj - dv) <= 1e-3 * max(1.0, dj)


def test_oc_replica_tile_matches_in_core_pass():
    """The out-of-core chunked replica scan, fed d_base from the same
    expansion, selects what the in-core pass selects."""
    from spfresh_tpu.clustering.outofcore import _oc_replica_tile, _pad_cents

    X, base, cents = _case(7, 400, 64, 48, "float32")
    bt = 1.25
    D = np.asarray(jax.vmap(lambda x, c: jnp.sum((x - c) ** 2))(
        X, cents[base]))
    cents_p, chunk = _pad_cents(np.asarray(cents), 16)
    od, oi = _oc_replica_tile(
        X, base, jnp.asarray(bt * D, jnp.float32), jnp.asarray(D),
        jnp.asarray(cents_p), "Euclidean", chunk, 64, 3,
    )
    _check_against_reference(oi, od, X, base, cents, bt)


@pytest.mark.parametrize(
    "n,C,d,dtype",
    [(500, 37, 19, "float32"), (300, 1100, 64, "float32"),
     (700, 90, 48, "bfloat16")],
)
def test_nearest_centroid_matches_numpy_reference(n, C, d, dtype):
    """The out-of-core base assign (`_oc_base_tile`) against a float64
    argmin: same nearest ids except at rounding-level ties (lowest id wins
    exact ties), distances to rounding."""
    from spfresh_tpu.clustering.outofcore import _oc_base_tile, _pad_cents

    X, _, cents = _case(9, n, C, d, dtype)
    Xf = X.astype(jnp.float32)
    cents_p, chunk = _pad_cents(np.asarray(cents, np.float32), 512)
    kb, kd = _oc_base_tile(Xf, jnp.asarray(cents_p), "Euclidean", chunk, C)
    bad = nearest_mismatches(kb, kd, Xf, cents)
    assert not bad, f"rows {bad[:10]} are not nearest to rounding"


def test_grouped_build_bit_identical(monkeypatch):
    """A Euclidean build whose closure pass runs in many row groups
    (including a ragged last one) equals the one-group build exactly."""
    from spfresh_tpu.clustering import hierarchical as H

    rng = np.random.default_rng(7)
    data = rng.standard_normal((900, 24)).astype(np.float32)
    params = H.ClusteringParams(desired_cluster_size=40, rng_seed=5)
    one = H.HierarchicalClustering(params, data).fit()
    monkeypatch.setattr(H, "_REPLICA_WORKSPACE_ELEMS", 1)  # 256-row groups
    grouped = H.HierarchicalClustering(params, data).fit()
    key = lambda hc: [(c.centroid_idx, c.points.tolist()) for c in hc.clusters]  # noqa: E731
    assert key(one) == key(grouped)


def test_build_full_probe_exact(tmp_path):
    """End-to-end: a build through the XLA closure pass yields a valid
    index — full-probe recall exactly 1.0, dedup invariant."""
    from spfresh_tpu.index.builder import SpannIndexBuilder
    from spfresh_tpu.index.config import Config

    rng = np.random.default_rng(11)
    data = rng.standard_normal((800, 24)).astype(np.float32)
    cfg = Config.from_dict(
        {
            "output_path": str(tmp_path / "idx"),
            "clustering_params": {"desired_cluster_size": 40, "rng_seed": 5},
        }
    )
    idx = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    q = data[:32]
    ids, dists = idx.search(q, 10, nprobe=idx.num_clusters, engine="csr")
    ids = np.asarray(ids)
    assert np.all(ids[:, 0] == np.arange(32))
    assert np.allclose(np.asarray(dists)[:, 0], 0.0, atol=1e-5)
    for row in ids:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)


def test_unfused_elementwise_route_matches_one_program():
    """The L1/Linf closure pass runs UNFUSED (separate pairwise + selection
    dispatches); it must equal the one-program pass bit-for-bit."""
    from spfresh_tpu.clustering.hierarchical import _replica_select_from_dists
    from spfresh_tpu.ops.distances import pairwise_distance

    rng = np.random.default_rng(11)
    X = jnp.asarray(rng.standard_normal((700, 48)).astype(np.float32))
    cents = jnp.asarray(rng.standard_normal((90, 48)).astype(np.float32))
    base = jnp.asarray(rng.integers(0, 90, 700).astype(np.int32))
    for metric in ("Manhattan", "Chebyshev"):
        fi, fd = _final_replica_pass(X, base, cents, metric, jnp.float32(1.15), 3)
        D = pairwise_distance(X, cents, metric)
        CC = pairwise_distance(jnp.take(cents, base, axis=0), cents, metric)
        ui, ud = _replica_select_from_dists(D, CC, base, jnp.float32(1.15), 3)
        np.testing.assert_array_equal(np.asarray(fi), np.asarray(ui))
        np.testing.assert_array_equal(np.asarray(fd), np.asarray(ud))


def test_bf16_wire_build_deterministic(tmp_path):
    """With a bf16 corpus wire the replica pass takes value-lossless bf16
    inputs; two builds of the same config and seed produce the SAME index
    (identical posting membership per cluster)."""
    from spfresh_tpu.index.builder import SpannIndexBuilder
    from spfresh_tpu.index.config import Config

    rng = np.random.default_rng(23)
    data = rng.standard_normal((900, 24)).astype(np.float32)

    def build(tag):
        cfg = Config.from_dict(
            {
                "output_path": str(tmp_path / f"idx_{tag}"),
                "storage_dtype": "bfloat16",  # => wire_dtype bfloat16
                "clustering_params": {"desired_cluster_size": 40, "rng_seed": 5},
            }
        )
        return SpannIndexBuilder(cfg).with_data(data).build(save=False)

    a = build("a")
    b = build("b")
    assert a.num_clusters == b.num_clusters
    assert sorted(a.postings) == sorted(b.postings)
    for cid in a.postings:
        assert np.array_equal(
            np.sort(a.postings[cid][0]), np.sort(b.postings[cid][0])
        ), cid
