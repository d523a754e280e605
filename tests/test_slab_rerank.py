"""Stage 2 of the slab search engine (``ops.distances.slab_distances``):
whole posting slabs gathered by XLA and reduced against the query, for
float slabs and the int8 residual tier, checked against float64 numpy; and
the slab and CSR engines' agreement through ``SpannIndex.search``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spfresh_tpu.index import Config, SpannIndexBuilder, brute_force_search
from spfresh_tpu.ops.distances import (
    pairwise_distance,
    rowwise_distance,
    slab_distances,
)

METRICS = ("Euclidean", "Manhattan", "Chebyshev")


def _numpy_distances(metric, v, q):
    diff = np.abs(v.astype(np.float64) - q.astype(np.float64))
    if metric == "Euclidean":
        return (diff ** 2).sum(-1)
    if metric == "Manhattan":
        return diff.sum(-1)
    return diff.max(-1)


def _float_case(rng, d, pad, dtype, C=6, Q=3, nprobe=4):
    vecs = jnp.asarray(rng.standard_normal((C, pad, d)), jnp.float32)
    vecs = vecs.astype(dtype)
    q = jnp.asarray(rng.standard_normal((Q, d)), jnp.float32)
    rows = jnp.asarray(rng.integers(0, C, (Q, nprobe)), jnp.int32)
    return q, rows, vecs


def _int8_case(rng, d, pad, C=6, Q=3, nprobe=4):
    codes = jnp.asarray(rng.integers(-127, 128, (C, pad, d)), jnp.int8)
    qc = jnp.asarray(0.5 * rng.standard_normal((Q, nprobe, d)), jnp.float32)
    scales = jnp.asarray(rng.uniform(0.001, 0.02, (Q, nprobe)), jnp.float32)
    rows = jnp.asarray(rng.integers(0, C, (Q, nprobe)), jnp.int32)
    return jnp.zeros((Q, d), jnp.float32), rows, codes, scales, qc


def _case_and_want(rng, metric, dtype, d, pad, **sizes):
    if dtype == "int8":
        q, rows, vecs, scales, qc = _int8_case(rng, d, pad, **sizes)
        kw = dict(scales=scales, centered_queries=qc)
        v = np.asarray(vecs, np.float64)[np.asarray(rows)] * np.asarray(
            scales, np.float64)[..., None, None]
        want = _numpy_distances(metric, v, np.asarray(qc)[:, :, None, :])
    else:
        q, rows, vecs = _float_case(rng, d, pad, jnp.dtype(dtype), **sizes)
        kw = {}
        v = np.asarray(vecs.astype(jnp.float32))[np.asarray(rows)]
        want = _numpy_distances(metric, v, np.asarray(q)[:, None, None, :])
    return q, rows, vecs, kw, want


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d,pad", [(96, 20), (128, 33), (960, 17)])
def test_slab_distances_match_float64(rng, metric, dtype, d, pad):
    """Every metric x slab dtype x width, with a pad that is no power of
    two: (Q, nprobe, pad) distances equal float64 numpy to f32 rounding."""
    q, rows, vecs, kw, want = _case_and_want(rng, metric, dtype, d, pad)
    out = np.asarray(slab_distances(q, rows, vecs, metric, **kw))
    assert out.shape == (*rows.shape, pad)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-4)


def test_slab_distances_equal_rowwise_of_gather(rng):
    """The slab form is exactly ``rowwise_distance`` over the gathered
    slabs — the same reduction the CSR engine runs per member row."""
    q, rows, vecs = _float_case(rng, 128, 32, jnp.float32, C=16, Q=8, nprobe=8)
    out = np.asarray(slab_distances(q, rows, vecs, "Euclidean"))
    gathered = vecs[rows]
    ref = np.asarray(rowwise_distance(gathered, q[:, None, None, :], "Euclidean"))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("metric", METRICS)
def test_int8_slabs_equal_dequantized_float_slabs(rng, metric):
    """Residual codes with per-probe scales against CENTERED queries give
    the distances of the dequantized float slabs against the raw query."""
    C, pad, d, Q, nprobe = 5, 12, 32, 3, 2
    cents = rng.standard_normal((C, d)).astype(np.float32)
    codes = rng.integers(-127, 128, (C, pad, d)).astype(np.int8)
    scale = rng.uniform(0.005, 0.02, C).astype(np.float32)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    rows = rng.integers(0, C, (Q, nprobe)).astype(np.int32)
    x = cents[:, None, :] + scale[:, None, None] * codes.astype(np.float32)
    qc = q[:, None, :] - cents[rows]
    out = np.asarray(slab_distances(
        jnp.asarray(q), jnp.asarray(rows), jnp.asarray(codes), metric,
        scales=jnp.asarray(scale[rows]), centered_queries=jnp.asarray(qc)))
    want = np.asarray(slab_distances(
        jnp.asarray(q), jnp.asarray(rows), jnp.asarray(x), metric))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def _index(tmp_path, rng, n=300, d=24, storage="float32"):
    data = rng.standard_normal((n, d)).astype(np.float32)
    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": 4,
                "desired_cluster_size": 40,
                "rng_seed": 42,
            },
            "output_path": str(tmp_path / "idx"),
            "storage_dtype": storage,
        }
    )
    return data, SpannIndexBuilder(cfg).with_data(data).build(save=False)


def test_slab_engine_matches_csr_engine(tmp_path, rng):
    data, index = _index(tmp_path, rng)
    queries = rng.standard_normal((6, 24)).astype(np.float32)
    for nprobe in (2, index.num_clusters):
        ids_x, d_x = index.search(queries, k=8, nprobe=nprobe, engine="csr")
        ids_p, d_p = index.search(queries, k=8, nprobe=nprobe, engine="slab")
        np.testing.assert_array_equal(ids_x, ids_p)
        np.testing.assert_allclose(d_x, d_p, rtol=1e-5, atol=1e-5)
    # Full probe via the slab engine is exact too.
    ids_p, _ = index.search(queries, k=8, nprobe=index.num_clusters, engine="slab")
    _, gt = brute_force_search(data, queries, k=8)
    rec = np.mean([len(set(ids_p[q]) & set(gt[q])) / 8 for q in range(6)])
    assert rec == 1.0


def test_slab_engine_with_pruning(tmp_path, rng):
    data = rng.standard_normal((200, 16)).astype(np.float32)
    cfg = Config.from_dict(
        {
            "clustering_params": {"initial_k": 3, "desired_cluster_size": 40, "rng_seed": 1},
            "output_path": str(tmp_path / "idx"),
        }
    )
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    ids_x, d_x = index.search(q, k=5, nprobe=3, prune_factor=1.2, engine="csr")
    ids_p, d_p = index.search(q, k=5, nprobe=3, prune_factor=1.2, engine="slab")
    np.testing.assert_array_equal(ids_x, ids_p)


@pytest.mark.parametrize("metric", METRICS)
def test_slab_engine_matches_csr_on_bf16_storage(tmp_path, rng, metric):
    """bf16 storage: both layouts rerank against the unrounded queries, so
    an index that switches layout at its first live update keeps its
    answers."""
    data = rng.standard_normal((300, 24)).astype(np.float32)
    cfg = Config.from_dict(
        {
            "clustering_params": {"distance_metric": metric, "initial_k": 4,
                                  "desired_cluster_size": 40, "rng_seed": 42},
            "output_path": str(tmp_path / "idx"),
            "storage_dtype": "bfloat16",
        }
    )
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    q = rng.standard_normal((8, 24)).astype(np.float32)
    ids_s, d_s = index.search(q, k=8, nprobe=3, engine="slab")
    ids_c, d_c = index.search(q, k=8, nprobe=3, engine="csr")
    np.testing.assert_array_equal(ids_s, ids_c)
    np.testing.assert_allclose(d_s, d_c, rtol=1e-6, atol=1e-6)


def test_slab_engine_matches_csr_on_int8_storage(tmp_path, rng):
    """int8 residual slabs: the two engines agree."""
    data, index = _index(tmp_path, rng, storage="int8")
    q = data[:5] + 0.01 * rng.standard_normal((5, 24)).astype(np.float32)
    ids_s, d_s = index.search(q, k=5, nprobe=3, engine="slab")
    ids_c, d_c = index.search(q, k=5, nprobe=3, engine="csr")
    np.testing.assert_array_equal(ids_s, ids_c)
    np.testing.assert_allclose(d_s, d_c, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [("bfloat16", 128), ("float32", 960),
                                     ("int8", 128)])
def test_slab_distances_on_gpu(gpu, rng, dtype, d):
    """Stage 2 as XLA compiles it for the card, at real widths and a pad
    that is no power of two, against float64 numpy."""
    sizes = dict(C=512, Q=64, nprobe=16)
    for metric in METRICS:
        q, rows, vecs, kw, want = _case_and_want(rng, metric, dtype, d, 272,
                                                 **sizes)
        out = np.asarray(slab_distances(q, rows, vecs, metric, **kw))
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_expansion_not_tf32_on_gpu(gpu, rng):
    """The Euclidean expansion on the card stays within 1e-5 (|x|^2 + |y|^2)
    of float64 — TF32 products (~10 mantissa bits) would not."""
    x = rng.standard_normal((512, 960)).astype(np.float32)
    y = rng.standard_normal((1024, 960)).astype(np.float32)
    D = np.asarray(jax.block_until_ready(pairwise_distance(x, y, "Euclidean")))
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    n2 = (x64 ** 2).sum(1)[:, None] + (y64 ** 2).sum(1)[None, :]
    err = np.abs(D - (n2 - 2.0 * x64 @ y64.T)) / n2
    assert err.max() <= 1e-5
