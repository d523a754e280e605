"""Sharded padded view updates in place (no full repack) on live mutations.

RESULTS.md round-3 lever 3: streaming updates must scatter into the sharded
slab view the way the single-device PaddedView does — identity of the view
object across refreshes proves no rebuild happened, and results must match
the single-device oracle after every mutation class (append, delete/rewrite,
new posting, removed posting, overflow fallback)."""

import numpy as np

from spfresh_tpu.index import Config, SpannIndexBuilder, brute_force_search
from spfresh_tpu.parallel import ShardedSpannIndex, default_mesh


def _build(tmp_path, rng, n=400, dim=8, cap=40):
    data = rng.standard_normal((n, dim)).astype(np.float32)
    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": 4,
                "desired_cluster_size": cap,
                "rng_seed": 42,
            },
            "output_path": str(tmp_path / "idx"),
        }
    )
    return SpannIndexBuilder(cfg).with_data(data).build(save=False), data


def _assert_matches_oracle(sharded, index, queries, k=10):
    ids_s, d_s = sharded.search(queries, k=k, nprobe=index.num_clusters)
    ids_1, d_1 = index.search(queries, k=k, nprobe=index.num_clusters, engine="csr")
    for r in range(queries.shape[0]):
        assert set(ids_s[r].tolist()) == set(ids_1[r].tolist())


def test_append_path_no_rebuild(tmp_path, rng):
    index, data = _build(tmp_path, rng)
    sharded = ShardedSpannIndex(index, default_mesh(), engine="slab")
    q = rng.standard_normal((6, 8)).astype(np.float32)
    view0 = sharded.padded_view()
    # Streaming-insert shape: grow a few postings by appending new members.
    cids = sorted(index.postings)[:3]
    next_id = 50_000
    for c in cids:
        ids, vecs = index.postings[c]
        add = rng.standard_normal((3, 8)).astype(np.float32)
        new_ids = np.concatenate([ids, np.arange(next_id, next_id + 3)])
        next_id += 3
        index.replace_posting(c, new_ids, np.concatenate([vecs, add]))
    view1 = sharded.padded_view()
    assert view1 is view0, "append should land in place, not rebuild"
    _assert_matches_oracle(sharded, index, q)
    # The appended points are reachable.
    hit, _ = sharded.search(
        index.postings[cids[0]][1][-1][None, :], k=1, nprobe=index.num_clusters
    )
    assert hit[0, 0] == index.postings[cids[0]][0][-1]


def test_rewrite_and_new_posting_no_rebuild(tmp_path, rng):
    index, data = _build(tmp_path, rng)
    sharded = ShardedSpannIndex(index, default_mesh(), engine="slab")
    q = rng.standard_normal((6, 8)).astype(np.float32)
    view0 = sharded.padded_view()
    # Delete-shaped mutation: shrink one posting (slab rewrite).
    c0 = sorted(index.postings)[0]
    ids, vecs = index.postings[c0]
    index.replace_posting(c0, ids[:-2], vecs[:-2])
    # New posting on a free row.
    nv = rng.standard_normal((5, 8)).astype(np.float32)
    index.add_cluster(nv, np.arange(60_000, 60_005), nv.mean(axis=0))
    # Removed posting invalidates its row.
    c1 = sorted(index.postings)[1]
    removed_ids = set(index.postings[c1][0].tolist())
    index.remove_cluster(c1)
    view1 = sharded.padded_view()
    assert view1 is view0, "rewrites should land in place, not rebuild"
    _assert_matches_oracle(sharded, index, q)
    hit, _ = sharded.search(nv, k=1, nprobe=index.num_clusters)
    assert set(hit[:, 0].tolist()) <= set(range(60_000, 60_005))
    all_ids, _ = sharded.search(q, k=10, nprobe=index.num_clusters)
    # c1's exclusive points are unreachable (replicas may survive elsewhere).
    exclusive = removed_ids - {
        i for cc, (pids, _) in index.postings.items() for i in pids.tolist()
    }
    assert not (set(all_ids.ravel().tolist()) & exclusive)


def test_overflow_falls_back_to_rebuild(tmp_path, rng):
    index, data = _build(tmp_path, rng)
    sharded = ShardedSpannIndex(index, default_mesh(), engine="slab")
    view0 = sharded.padded_view()
    # Grow one posting beyond the slab width: must fall back to a full pack.
    c0 = sorted(index.postings)[0]
    ids, vecs = index.postings[c0]
    grow = view0.pad + 8 - len(ids)
    add = rng.standard_normal((grow, 8)).astype(np.float32)
    index.replace_posting(
        c0,
        np.concatenate([ids, np.arange(70_000, 70_000 + grow)]),
        np.concatenate([vecs, add]),
    )
    view1 = sharded.padded_view()
    assert view1 is not view0
    assert view1.pad >= view0.pad + 8
    q = rng.standard_normal((4, 8)).astype(np.float32)
    _assert_matches_oracle(sharded, index, q)


def test_xla_engine_view_still_rebuilds_correctly(tmp_path, rng):
    # The CSR (xla) view has no incremental path; generation check must
    # still give fresh results after updates.
    index, data = _build(tmp_path, rng)
    sharded = ShardedSpannIndex(index, default_mesh(), engine="csr")
    q = rng.standard_normal((4, 8)).astype(np.float32)
    sharded.search(q, k=5, nprobe=index.num_clusters)
    c0 = sorted(index.postings)[0]
    ids, vecs = index.postings[c0]
    index.replace_posting(c0, ids[:-1], vecs[:-1])
    _assert_matches_oracle(sharded, index, q)


def test_randomized_mutation_interleaving_matches_oracle(tmp_path, rng):
    """Fuzz the in-place update planner: random interleavings of appends,
    shrinks, new postings, removals, and overflow-forcing growths must keep
    the sharded view bit-equal to the single-device xla oracle after every
    round — including rounds whose planning aborts halfway into a repack
    (the ADVICE-r2 deferred-snapshot hazard)."""
    index, data = _build(tmp_path, rng)
    sharded = ShardedSpannIndex(index, default_mesh(), engine="slab")
    q = rng.standard_normal((6, 8)).astype(np.float32)
    next_id = 100_000
    for rnd in range(8):
        cids = sorted(index.postings)
        op = int(rng.integers(0, 4))
        if op == 0:  # appends to a few postings
            for c in rng.choice(cids, size=min(3, len(cids)), replace=False):
                ids, vecs = index.postings[int(c)]
                m = int(rng.integers(1, 4))
                add = rng.standard_normal((m, 8)).astype(np.float32)
                index.replace_posting(
                    int(c),
                    np.concatenate([ids, np.arange(next_id, next_id + m)]),
                    np.concatenate([vecs, add]),
                )
                next_id += m
        elif op == 1:  # shrink one, grow another in the same dirty set
            c0, c1 = int(cids[0]), int(cids[-1])
            ids, vecs = index.postings[c0]
            if len(ids) > 2:
                index.replace_posting(c0, ids[:-2], vecs[:-2])
            ids, vecs = index.postings[c1]
            add = rng.standard_normal((2, 8)).astype(np.float32)
            index.replace_posting(
                c1,
                np.concatenate([ids, np.arange(next_id, next_id + 2)]),
                np.concatenate([vecs, add]),
            )
            next_id += 2
        elif op == 2:  # new posting + remove an old one
            nv = rng.standard_normal((4, 8)).astype(np.float32)
            index.add_cluster(
                nv, np.arange(next_id, next_id + 4), nv.mean(axis=0)
            )
            next_id += 4
            if len(cids) > 3:
                index.remove_cluster(int(cids[1]))
        else:  # overflow: outgrow the slab width mid-plan
            view = sharded.padded_view()
            c0 = int(cids[int(rng.integers(0, len(cids)))])
            ids, vecs = index.postings[c0]
            grow = view.pad + 4 - len(ids)
            if grow > 0:
                add = rng.standard_normal((grow, 8)).astype(np.float32)
                index.replace_posting(
                    c0,
                    np.concatenate([ids, np.arange(next_id, next_id + grow)]),
                    np.concatenate([vecs, add]),
                )
                next_id += grow
        _assert_matches_oracle(sharded, index, q)


def test_int8_sharded_incremental_updates(tmp_path, rng):
    """int8 residual slabs under the sharded in-place update paths: appends
    quantize with the slab's existing scale; a rewrite (delete) recomputes
    the scale and scatters it; results keep matching the single-device
    oracle (both int8, same codes)."""
    n, dim, cap = 400, 8, 40
    centers = 3.0 * rng.standard_normal((8, dim)).astype(np.float32)
    data = (
        centers[rng.integers(0, 8, n)]
        + 0.2 * rng.standard_normal((n, dim))
    ).astype(np.float32)
    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": 4,
                "desired_cluster_size": cap,
                "rng_seed": 42,
            },
            "output_path": str(tmp_path / "idx8"),
            "storage_dtype": "int8",
        }
    )
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    sharded = ShardedSpannIndex(index, default_mesh(), engine="slab")
    q = data[:6]
    view0 = sharded.padded_view()
    _assert_matches_oracle(sharded, index, q)
    # Append fast path: new members quantize with the existing slab scale.
    cids = sorted(index.postings)[:2]
    next_id = 50_000
    for c in cids:
        ids, vecs = index.postings[c]
        add = (index.centroids[c][None, :]
               + 0.1 * rng.standard_normal((3, dim))).astype(np.float32)
        index.replace_posting(
            c, np.concatenate([ids, np.arange(next_id, next_id + 3)]),
            np.concatenate([np.asarray(vecs), add]),
        )
        next_id += 3
    view1 = sharded.padded_view()
    assert view1 is view0, "append should land in place, not rebuild"
    _assert_matches_oracle(sharded, index, q)
    # Rewrite path: shrink a posting (delete members) — scale recomputed.
    c0 = cids[0]
    ids0, vecs0 = index.postings[c0]
    index.replace_posting(c0, ids0[:-5], np.asarray(vecs0)[:-5])
    view2 = sharded.padded_view()
    assert view2 is view0
    _assert_matches_oracle(sharded, index, q)
    # Appended points reachable with near-zero distance to themselves.
    v = np.asarray(index.postings[cids[1]][1])[-1]
    hit, d = sharded.search(v[None, :], k=1, nprobe=index.num_clusters)
    assert hit[0, 0] == index.postings[cids[1]][0][-1]
    assert float(d[0, 0]) < 0.02
