"""Chunked centroid scan (large-C stage-1 probe) must be exactly equivalent
to the dense (Q, C) scan + top_k."""

import jax.numpy as jnp
import numpy as np
import pytest

from spfresh_tpu.ops.distances import pairwise_distance
from spfresh_tpu.ops.topk import chunked_centroid_topk, smallest_k


@pytest.mark.parametrize("metric", ["Euclidean", "Manhattan"])
@pytest.mark.parametrize("C,chunk", [(1000, 256), (777, 128), (64, 256)])
def test_chunked_matches_dense(rng, metric, C, chunk):
    d, Q, nprobe = 32, 9, 7
    cents = rng.standard_normal((C, d)).astype(np.float32)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    valid = np.ones(C, bool)
    valid[5] = False  # an invalid row must never be selected
    dv, iv = chunked_centroid_topk(
        jnp.asarray(q), jnp.asarray(cents), jnp.asarray(valid),
        nprobe, metric, chunk=chunk,
    )
    D = pairwise_distance(jnp.asarray(q), jnp.asarray(cents), metric)
    D = jnp.where(jnp.asarray(valid)[None, :], D, jnp.inf)
    dd, di = smallest_k(D, nprobe)
    np.testing.assert_allclose(np.asarray(dv), np.asarray(dd), rtol=1e-6)
    assert not (np.asarray(iv) == 5).any()
    # Tie order may differ between the two selectors; distances fix the set.
    for r in range(Q):
        got = {(round(float(x), 4)) for x in np.asarray(dv)[r]}
        want = {(round(float(x), 4)) for x in np.asarray(dd)[r]}
        assert got == want


def test_search_kernel_uses_chunked_past_threshold(rng, monkeypatch):
    """Force the threshold low and check the full search pipeline still
    returns exact full-probe results through the chunked stage-1."""
    import spfresh_tpu.ops.topk as topk_mod

    monkeypatch.setattr(topk_mod, "LARGE_C_THRESHOLD", 4)
    from spfresh_tpu.index import Config, SpannIndex, brute_force_search

    data = rng.standard_normal((240, 16)).astype(np.float32)
    index = SpannIndex(Config())
    for c in range(12):
        ids = np.arange(c * 20, (c + 1) * 20, dtype=np.int64)
        index.add_cluster(data[ids], ids, centroid=data[ids[0]])
    q = rng.standard_normal((5, 16)).astype(np.float32)
    ids_x, _ = index.search(q, k=8, nprobe=index.num_clusters, engine="csr")
    ids_p, _ = index.search(q, k=8, nprobe=index.num_clusters, engine="slab")
    _, gt = brute_force_search(data, q, k=8)
    for r in range(5):
        assert set(ids_x[r].tolist()) == set(gt[r].tolist())
        assert set(ids_p[r].tolist()) == set(gt[r].tolist())


@pytest.mark.parametrize("metric", ["Manhattan", "Chebyshev", "Euclidean"])
def test_brute_force_chunked_exact_all_metrics(rng, metric):
    """Past the 10k-row threshold ground truth goes through the chunked scan
    for every metric — it must equal a direct numpy computation."""
    from spfresh_tpu.index import brute_force_search

    n, d, Q, k = 12_000, 24, 7, 5
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    dists, idx = brute_force_search(corpus, q, k, metric=metric)
    diff = np.abs(corpus[None, :, :] - q[:, None, :])
    if metric == "Euclidean":
        D = (diff ** 2).sum(-1)
    elif metric == "Manhattan":
        D = diff.sum(-1)
    else:
        D = diff.max(-1)
    want = np.sort(D, axis=1)[:, :k]
    np.testing.assert_allclose(np.sort(dists, axis=1), want, rtol=1e-4, atol=1e-4)


# -- chunked_centroid_topk against a float64 dense oracle ---------------------


def _oracle(qf, cents, valid, nprobe):
    qf = np.asarray(qf, np.float64)
    cf = np.asarray(cents, np.float64)
    D = ((qf[:, None, :] - cf[None, :, :]) ** 2).sum(-1)
    D = np.where(np.asarray(valid)[None, :], D, np.inf)
    order = np.argsort(D, axis=1, kind="stable")[:, :nprobe]
    return np.take_along_axis(D, order, 1), order


def _check(qf, cents, valid, nprobe, chunk=8192):
    got_d, got_i = chunked_centroid_topk(
        jnp.asarray(qf), jnp.asarray(cents), jnp.asarray(valid), nprobe,
        "Euclidean", chunk=chunk,
    )
    exp_d, exp_i = _oracle(qf, cents, valid, nprobe)
    got_d, got_i = np.asarray(got_d), np.asarray(got_i)
    finite = np.isfinite(exp_d)
    assert np.array_equal(finite, np.isfinite(got_d))
    assert np.allclose(got_d[finite], exp_d[finite], rtol=1e-4, atol=1e-3)
    assert np.all(np.diff(np.where(finite, got_d, 1e30), axis=1) >= -1e-6)
    for q in range(exp_i.shape[0]):
        ge = set(exp_i[q][finite[q]].tolist())
        gg = set(got_i[q][finite[q]].tolist())
        if ge != gg:  # near-ties may legally swap across the top-k boundary
            edge = exp_d[q][finite[q]].max()
            for i in ge ^ gg:
                d = float(((np.asarray(qf[q], np.float64)
                            - np.asarray(cents[i], np.float64)) ** 2).sum())
                assert abs(d - edge) < 1e-3 * (1 + abs(edge))
    return got_d, got_i


def test_chunked_scan_matches_oracle_basic():
    rng = np.random.default_rng(0)
    cents = rng.standard_normal((3000, 48)).astype(np.float32)
    qf = rng.standard_normal((37, 48)).astype(np.float32)
    _check(qf, cents, np.ones(3000, bool), nprobe=9, chunk=1024)


def test_chunked_scan_invalid_centroids_excluded():
    rng = np.random.default_rng(1)
    cents = rng.standard_normal((1500, 16)).astype(np.float32)
    qf = rng.standard_normal((5, 16)).astype(np.float32)
    valid = np.ones(1500, bool)
    valid[::3] = False
    _, got_i = _check(qf, cents, valid, nprobe=8, chunk=512)
    assert np.all(got_i % 3 != 0)


def test_chunked_scan_many_chunks_merge():
    rng = np.random.default_rng(2)
    cents = rng.standard_normal((4096, 8)).astype(np.float32)
    qf = rng.standard_normal((11, 8)).astype(np.float32)
    # chunk=1024 forces 4 chunks through the running top-k merge.
    _check(qf, cents, np.ones(4096, bool), nprobe=6, chunk=1024)


def test_chunked_scan_bf16_centroids():
    rng = np.random.default_rng(3)
    cents = rng.standard_normal((2048, 32)).astype(np.float32)
    qf = rng.standard_normal((9, 32)).astype(np.float32)
    cb = jnp.asarray(cents).astype(jnp.bfloat16)
    got_d, _ = chunked_centroid_topk(
        jnp.asarray(qf).astype(jnp.bfloat16), cb, jnp.ones(2048, bool), 4,
        "Euclidean", chunk=512,
    )
    # bf16 storage: oracle on the bf16-rounded values.
    exp_d, _ = _oracle(
        np.asarray(jnp.asarray(qf).astype(jnp.bfloat16).astype(jnp.float32)),
        np.asarray(cb.astype(jnp.float32)), np.ones(2048, bool), 4,
    )
    assert np.allclose(np.asarray(got_d), exp_d, rtol=1e-3, atol=1e-2)


def test_chunked_scan_nprobe_exceeds_chunk():
    # nprobe > chunk: the running state is wider than one block; the result
    # is still the full exact top-k.
    rng = np.random.default_rng(4)
    cents = rng.standard_normal((256, 8)).astype(np.float32)
    qf = rng.standard_normal((3, 8)).astype(np.float32)
    _check(qf, cents, np.ones(256, bool), nprobe=16, chunk=8)


def test_chunked_scan_fewer_valid_than_nprobe():
    rng = np.random.default_rng(5)
    cents = rng.standard_normal((300, 8)).astype(np.float32)
    qf = rng.standard_normal((2, 8)).astype(np.float32)
    valid = np.zeros(300, bool)
    valid[:5] = True
    got_d, got_i = chunked_centroid_topk(
        jnp.asarray(qf), jnp.asarray(cents), jnp.asarray(valid), 8,
        "Euclidean", chunk=128,
    )
    got_d = np.asarray(got_d)
    assert np.all(np.isfinite(got_d[:, :5])) and np.all(~np.isfinite(got_d[:, 5:]))
    assert set(np.asarray(got_i)[:, :5].ravel().tolist()) <= set(range(5))
