"""Incremental padded-view updates: live mutations scatter into the device
slabs in place; results must stay EXACTLY equal to a from-scratch pack (the
CSR engine rebuilds fully, so slab-vs-csr equality proves it)."""

import numpy as np
import pytest

from spfresh_tpu.index import Config, SpannIndex, brute_force_search
from spfresh_tpu.utils import metrics


def _mk_index(rng, n=240, dim=32, clusters=6):
    data = rng.standard_normal((n, dim)).astype(np.float32)
    index = SpannIndex(Config.from_dict({}))
    per = n // clusters
    for c in range(clusters):
        ids = np.arange(c * per, (c + 1) * per, dtype=np.int64)
        index.add_cluster(data[ids], ids, centroid=data[ids[0]].copy())
    return index, data


def _incr_count():
    return metrics.snapshot().get("view.incremental_updates", 0)


def test_insert_scatters_in_place(rng):
    index, data = _mk_index(rng)
    index.padded_view()  # full pack
    v3_before = index.padded_view().vectors3d
    before = _incr_count()

    # Mutate one posting: append a vector.
    cid = sorted(index.postings)[2]
    ids, vecs = index.postings[cid]
    nv = rng.standard_normal(32).astype(np.float32)
    index.replace_posting(cid, np.append(ids, 9999), np.concatenate([vecs, nv[None]]))
    view = index.padded_view()
    assert _incr_count() == before + 1  # incremental, not a repack

    # The new vector is reachable and results match the (fully rebuilt) xla
    # engine and brute force.
    q = nv[None, :] + 0.01
    ids_p, d_p = index.search(q, k=5, nprobe=index.num_clusters, engine="slab")
    ids_x, d_x = index.search(q, k=5, nprobe=index.num_clusters, engine="csr")
    np.testing.assert_array_equal(ids_p, ids_x)
    np.testing.assert_allclose(d_p, d_x, rtol=1e-5, atol=1e-5)
    assert ids_p[0, 0] == 9999


def test_delete_and_remove_cluster_in_place(rng):
    index, data = _mk_index(rng)
    index.padded_view()
    cids = sorted(index.postings)
    # Delete a vector from one posting.
    cid = cids[0]
    ids, vecs = index.postings[cid]
    victim = int(ids[3])
    keep = ids != victim
    index.replace_posting(cid, ids[keep], vecs[keep])
    # Remove another cluster entirely.
    gone = cids[1]
    gone_members = set(index.postings[gone][0].tolist())
    index.remove_cluster(gone)
    view = index.padded_view()
    assert gone not in view.cluster_rows

    queries = data[:16]
    ids_p, _ = index.search(queries, k=8, nprobe=index.num_clusters, engine="slab")
    ids_x, _ = index.search(queries, k=8, nprobe=index.num_clusters, engine="csr")
    np.testing.assert_array_equal(ids_p, ids_x)
    hit = set(ids_p.ravel().tolist())
    assert victim not in hit
    assert not (gone_members & hit)


def test_new_cluster_takes_free_row(rng):
    index, data = _mk_index(rng)
    v0 = index.padded_view()
    free_before = len(v0.free_rows)
    nv = rng.standard_normal((4, 32)).astype(np.float32)
    cid = index.add_cluster(nv, np.arange(5000, 5004), centroid=nv[0].copy())
    view = index.padded_view()
    assert view is v0  # same view object, updated in place
    assert view.cluster_rows[cid] is not None
    assert len(view.free_rows) == free_before - 1
    ids_p, _ = index.search(nv[2:3], k=1, nprobe=index.num_clusters, engine="slab")
    assert ids_p[0, 0] == 5002


def test_slab_overflow_falls_back_to_full_pack(rng):
    index, data = _mk_index(rng)
    view = index.padded_view()
    pad = view.pad
    cid = sorted(index.postings)[0]
    ids, vecs = index.postings[cid]
    # Grow one posting past the slab width: must trigger a full repack with a
    # wider pad, still correct.
    extra = rng.standard_normal((pad, 32)).astype(np.float32)
    index.replace_posting(
        cid,
        np.concatenate([ids, np.arange(7000, 7000 + pad)]),
        np.concatenate([vecs, extra]),
    )
    view2 = index.padded_view()
    assert view2 is not view
    assert view2.pad > pad
    ids_p, _ = index.search(extra[0:1], k=1, nprobe=index.num_clusters, engine="slab")
    assert ids_p[0, 0] == 7000


def test_incremental_matches_brute_force_over_update_stream(rng):
    """Randomized stream of inserts/deletes; after each step the slab view
    (incrementally updated) must return full-probe recall 1.0 vs brute force
    over the live corpus."""
    index, data = _mk_index(rng, n=120, dim=16, clusters=4)
    live = {int(i): data[i] for i in range(120)}
    index.padded_view()
    next_id = 10_000
    for step in range(6):
        # insert 3
        for _ in range(3):
            v = rng.standard_normal(16).astype(np.float32)
            cid = sorted(index.postings)[int(rng.integers(index.num_clusters))]
            ids, vecs = index.postings[cid]
            index.replace_posting(
                cid, np.append(ids, next_id), np.concatenate([vecs, v[None]])
            )
            live[next_id] = v
            next_id += 1
        # delete 2
        for _ in range(2):
            cid = sorted(index.postings)[int(rng.integers(index.num_clusters))]
            ids, vecs = index.postings[cid]
            if len(ids) <= 1:
                continue
            j = int(rng.integers(len(ids)))
            live.pop(int(ids[j]), None)
            keep = np.arange(len(ids)) != j
            index.replace_posting(cid, ids[keep], vecs[keep])

        corpus_ids = np.array(sorted(live), np.int64)
        corpus = np.stack([live[int(i)] for i in corpus_ids])
        q = rng.standard_normal((4, 16)).astype(np.float32)
        _, gt_rows = brute_force_search(corpus, q, k=5)
        gt = corpus_ids[gt_rows]
        ids_p, _ = index.search(q, k=5, nprobe=index.num_clusters, engine="slab")
        # full probe, no pruning -> exact (the repo's standing invariant)
        for r in range(4):
            assert set(ids_p[r].tolist()) == set(gt[r].tolist()), step


def test_chunked_pack_multi_chunk_matches_single(rng, monkeypatch):
    """The bounded-memory slab pack (spann._PACK_CHUNK pieces + idempotent
    tail padding) must produce the same view as a one-shot pack: shrink the
    chunk so a small index needs several pieces, both pack flavors."""
    import jax.numpy as jnp

    from spfresh_tpu.index import Config, SpannIndex
    from spfresh_tpu.index import spann as spann_mod

    monkeypatch.setattr(spann_mod, "_PACK_CHUNK", 32)
    n, dim = 300, 16
    data = rng.standard_normal((n, dim)).astype(np.float32)

    def build():
        idx = SpannIndex(Config.from_dict({}))
        for c in range(6):
            ids = np.arange(c * 50, (c + 1) * 50, dtype=np.int64)
            idx.add_cluster(data[ids], ids, centroid=data[ids[0]])
        return idx

    # Host-flat pack path (several 32-row chunks).
    idx = build()
    view = idx.padded_view()
    assert np.asarray(view.lens)[:6].tolist() == [50] * 6
    for c in range(6):
        row = view.cluster_rows[c]
        got = np.asarray(view.vectors3d)[row, :50, :dim]
        np.testing.assert_allclose(got, data[c * 50 : (c + 1) * 50], atol=1e-6)
        assert np.asarray(view.ids2d)[row, :50].tolist() == list(range(c * 50, (c + 1) * 50))
        assert np.all(np.asarray(view.ids2d)[row, 50:] == -1)

    # Zero-upload (device corpus) pack path.
    idx2 = build()
    idx2._flat_cache = None
    idx2._corpus_cache = (idx2._gen, jnp.asarray(data))
    view2 = idx2.padded_view()
    np.testing.assert_allclose(
        np.asarray(view2.vectors3d), np.asarray(view.vectors3d), atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(view2.ids2d), np.asarray(view.ids2d))
