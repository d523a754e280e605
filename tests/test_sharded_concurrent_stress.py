"""Sharded search racing live updates (round 5; VERDICT r4 item 7).

The sharded view tracks the base index by generation
(`ShardedSpannIndex.padded_view` scatters only postings whose
`_mutated_gen` advanced) — the same incremental-refresh class where the
round-4 stress work found the lazy routing-tier snapshot race (RESULTS.md
bug 11).  Here a SEARCHER thread full-probes through the sharded view on
the 8-device CPU mesh while a MUTATOR drives SpFreshIndex inserts and
deletes into the underlying index.

Assertions: no thread raises; no result row ever carries a duplicate id;
a far-away anchor vector (never mutated) stays its own top-1 the whole
run; after quiescing + flush, the sharded full-probe result set equals
the single-device XLA oracle and agrees with the live-set model."""

import threading
import traceback

import numpy as np

from spfresh_tpu.index import Config, SpannIndexBuilder
from spfresh_tpu.lire import LireConfig
from spfresh_tpu.lire.fresh import SpFreshIndex
from spfresh_tpu.parallel import ShardedSpannIndex, default_mesh

DIM = 8


def test_sharded_search_races_live_updates(tmp_path):
    rng = np.random.default_rng(0)
    data = 2.0 * rng.standard_normal((300, DIM)).astype(np.float32)
    # A far-off anchor no mutation will ever approach: its self-query top-1
    # must hold through every refresh the searcher observes.
    data[0] = 50.0
    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": 4,
                "desired_cluster_size": 60,
                "rng_seed": 42,
            },
            "output_path": str(tmp_path / "shc"),
        }
    )
    index = SpannIndexBuilder(cfg).with_data(data).build(save=True)
    fresh = SpFreshIndex(
        index,
        str(tmp_path / "shc_lire"),
        lire_config=LireConfig(max_partition_size=120, min_partition_size=2),
    )
    sharded = ShardedSpannIndex(index, default_mesh(), engine="csr")
    stop = threading.Event()
    errors = []
    deleted_lock = threading.Lock()
    deleted_confirmed: set = set()

    anchor_q = data[0][None, :]

    def searcher():
        try:
            qs = np.concatenate([anchor_q, data[5:9]], axis=0)
            while not stop.is_set():
                k = 5
                ids, dists = sharded.search(
                    qs, k=k, nprobe=index.num_clusters
                )
                # No duplicate ids within a row (the dedup-bound contract).
                for r in range(ids.shape[0]):
                    row = [i for i in ids[r].tolist() if i >= 0]
                    assert len(row) == len(set(row)), f"dup ids: {ids[r]}"
                assert ids[0, 0] == 0, f"anchor lost: {ids[0]}"
                # Vids whose delete() RETURNED before this search started
                # must not appear (snapshot the set before searching).
                with deleted_lock:
                    dead = set(deleted_confirmed)
                hit_dead = dead & {
                    int(i) for i in ids.ravel().tolist() if i >= 0
                }
                assert not hit_dead, f"deleted vids served: {hit_dead}"
        except Exception:  # noqa: BLE001 — surfaced via errors
            errors.append(("searcher", traceback.format_exc()))
            stop.set()

    def mutator():
        try:
            mrng = np.random.default_rng(1)
            next_vid = 10_000
            live_new = []
            for round_ in range(40):
                if stop.is_set():
                    return
                vecs = mrng.standard_normal((6, DIM)).astype(np.float32)
                vids = list(range(next_vid, next_vid + 6))
                next_vid += 6
                for vid, v in zip(vids, vecs):
                    fresh.insert(v, vid)
                    live_new.append(vid)
                if len(live_new) > 8:
                    doomed = [live_new.pop(0) for _ in range(4)]
                    fresh.delete_batch(doomed)
                    with deleted_lock:
                        deleted_confirmed.update(doomed)
        except Exception:  # noqa: BLE001
            errors.append(("mutator", traceback.format_exc()))
            stop.set()

    ts = threading.Thread(target=searcher)
    tm = threading.Thread(target=mutator)
    ts.start()
    tm.start()
    tm.join(timeout=120)
    stop.set()
    ts.join(timeout=60)
    assert not errors, errors[0][1]

    # Quiesced: the sharded view must converge to the oracle exactly.
    fresh.flush()
    qs = np.concatenate([anchor_q, data[20:26]], axis=0)
    ids_s, _ = sharded.search(qs, k=8, nprobe=index.num_clusters)
    ids_1, _ = index.search(qs, k=8, nprobe=index.num_clusters, engine="csr")
    for r in range(qs.shape[0]):
        assert set(ids_s[r].tolist()) == set(ids_1[r].tolist())
    # Live-set model: confirmed-deleted vids are gone from the index.
    with deleted_lock:
        dead = set(deleted_confirmed)
    for pid, (pids_, _vecs) in index.postings.items():
        served = set(int(i) for i in pids_.tolist())
        assert not (served & dead), f"posting {pid} serves deleted vids"
