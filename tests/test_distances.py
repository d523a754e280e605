"""Distance kernel tests — golden values mirror the reference's unit tests
(/root/reference/src/distances/distance.rs:45-105)."""

import jax.numpy as jnp
import numpy as np
import pytest

from spfresh_tpu.ops import (
    CHEBYSHEV,
    EUCLIDEAN,
    MANHATTAN,
    METRICS,
    canonical_metric,
    distance,
    pairwise_distance,
    rowwise_distance,
)

A = np.array([1.0, 2.0, 3.0], np.float32)
B = np.array([4.0, 6.0, 8.0], np.float32)


def test_squared_euclidean_golden():
    # (4-1)^2 + (6-2)^2 + (8-3)^2 = 9 + 16 + 25 = 50
    assert float(distance(A, B, EUCLIDEAN)) == pytest.approx(50.0)


def test_manhattan_golden():
    # |3| + |4| + |5| = 12
    assert float(distance(A, B, MANHATTAN)) == pytest.approx(12.0)


def test_chebyshev_golden():
    # max(3, 4, 5) = 5
    assert float(distance(A, B, CHEBYSHEV)) == pytest.approx(5.0)


def test_zero_distance_all_metrics():
    for m in METRICS:
        assert float(distance(A, A, m)) == pytest.approx(0.0)


def test_pairwise_matches_scalar(rng):
    x = rng.standard_normal((17, 5)).astype(np.float32)
    y = rng.standard_normal((9, 5)).astype(np.float32)
    for m in METRICS:
        # Fast path: the matmul expansion for Euclidean loses ~1e-3 rel to
        # cancellation — acceptable for probe selection, hence loose tol.
        D = np.asarray(pairwise_distance(x, y, m))
        assert D.shape == (17, 9)
        for i in [0, 7, 16]:
            for j in [0, 4, 8]:
                assert D[i, j] == pytest.approx(float(distance(x[i], y[j], m)), rel=5e-3, abs=5e-3)
        # Exact path must match the scalar kernel tightly.
        De = np.asarray(pairwise_distance(x, y, m, exact=True))
        for i in [0, 7, 16]:
            for j in [0, 4, 8]:
                assert De[i, j] == pytest.approx(float(distance(x[i], y[j], m)), rel=1e-6, abs=1e-6)


def test_pairwise_euclidean_nonnegative(rng):
    x = rng.standard_normal((64, 32)).astype(np.float32) * 100
    D = np.asarray(pairwise_distance(x, x, EUCLIDEAN))
    assert (D >= 0).all()  # clamped: the expansion may go slightly negative
    # Diagonal error scales with |x|^2 * eps; exact path has none.
    De = np.asarray(pairwise_distance(x, x, EUCLIDEAN, exact=True))
    assert np.allclose(np.diag(De), 0.0)


def test_pairwise_tiling_consistency(rng):
    # Tiled VPU path must match regardless of tile size.
    x = rng.standard_normal((37, 8)).astype(np.float32)
    y = rng.standard_normal((11, 8)).astype(np.float32)
    for m in (MANHATTAN, CHEBYSHEV):
        a = np.asarray(pairwise_distance(x, y, m, tile_n=4))
        b = np.asarray(pairwise_distance(x, y, m, tile_n=1024))
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_bfloat16_storage_accumulates_f32(rng):
    x = rng.standard_normal((16, 64)).astype(np.float32)
    y = rng.standard_normal((8, 64)).astype(np.float32)
    D32 = np.asarray(pairwise_distance(x, y, EUCLIDEAN))
    Dbf = np.asarray(
        pairwise_distance(jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16), EUCLIDEAN)
    )
    assert Dbf.dtype == np.float32
    np.testing.assert_allclose(D32, Dbf, rtol=0.05, atol=0.5)


def test_rowwise_distance(rng):
    x = rng.standard_normal((12, 6)).astype(np.float32)
    y = rng.standard_normal((12, 6)).astype(np.float32)
    for m in METRICS:
        r = np.asarray(rowwise_distance(x, y, m))
        for i in [0, 5, 11]:
            assert r[i] == pytest.approx(float(distance(x[i], y[i], m)), rel=1e-5)


def test_canonical_metric_rejects_unknown():
    with pytest.raises(ValueError):
        canonical_metric("Cosine")
    assert canonical_metric("euclidean") == EUCLIDEAN


def test_distance_f64_host_path():
    """f64 parity capability (reference SpannFloat admits f64,
    core/float.rs:24-25): exact float64 semantics on the host; see the
    COMPONENTS.md decision for why the device path stays f32/bf16."""
    from spfresh_tpu.ops.distances import distance_f64

    u = np.array([1.0, 2.0, 3.0], np.float64)
    v = np.array([4.0, 6.0, 3.0], np.float64)
    assert distance_f64(u, v) == 25.0
    assert distance_f64(u, v, "Manhattan") == 7.0
    assert distance_f64(u, v, "Chebyshev") == 4.0
    assert isinstance(distance_f64(u, v), np.float64)
    # f64 precision actually preserved (would be lost in f32).
    a = np.array([1e9, 0.0])
    b = np.array([1e9 + 1.0, 0.0])
    assert distance_f64(a, b) == 1.0
    with pytest.raises(ValueError):
        distance_f64(u, v[:2])


@pytest.mark.parametrize("metric", [MANHATTAN, CHEBYSHEV])
@pytest.mark.parametrize("n,m,d", [(16, 128, 128), (19, 131, 70), (3, 5, 960)])
def test_elementwise_pairwise_matches_float64(rng, metric, n, m, d):
    """The tiled broadcast-reduce (the L1/Linf route on every platform)
    against float64 numpy, up to GIST width."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.standard_normal((m, d)).astype(np.float32)
    out = np.asarray(pairwise_distance(x, y, metric))
    diff = np.abs(x.astype(np.float64)[:, None, :] - y.astype(np.float64)[None])
    want = diff.sum(-1) if metric == MANHATTAN else diff.max(-1)
    np.testing.assert_allclose(out, want, rtol=1e-5)


def test_sq_l2_expansion_asks_for_highest_precision():
    """f32 operands must not meet the expansion's matmul in TF32 on the GPU:
    the dot carries Precision.HIGHEST in the traced program."""
    import jax

    from spfresh_tpu.ops.distances import _sq_l2_pairwise

    x = jnp.ones((4, 8), jnp.float32)
    jaxpr = str(jax.make_jaxpr(_sq_l2_pairwise)(x, x))
    assert "dot_general" in jaxpr
    assert "precision=(Precision.HIGHEST, Precision.HIGHEST)" in jaxpr
