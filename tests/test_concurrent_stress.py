"""Threaded stress over the disk-tier serving stack (round 4).

Four concurrent actors on one ``LazySpFreshIndex`` for a bounded wall:
TWO SEARCHERS running full-probe queries nonstop (two, so routing-tier
refreshes race each other — the _RouteSnap/_refresh_lock surface), a
MUTATOR interleaving inserts and deletes, and a COMPACTOR folding the
overlay.  The hand audits
fixed this surface piece by piece (retired-posting snapshots, pinned
moves, the compact reader-writer gate, WAL transaction boundaries) — this
test exercises the combination under real thread interleavings.

Assertions: no thread raises; a deleted vid never appears in results
after its delete returns; a known resident vid stays findable; the final
flushed state matches the surviving-model live set."""

import threading
import traceback

import numpy as np

from spfresh_tpu.index import Config, SpannIndexBuilder
from spfresh_tpu.lire import LireConfig, LireStorageError
from spfresh_tpu.lire.lazy_fresh import LazySpFreshIndex

DIM = 8


def _vid_state(fresh, vids):
    """Failure forensics, captured AT detection time (the interleavings
    here fire once in ~100 runs — the first trip must carry the evidence):
    where does each vid live right now — storage reverse index, the RAM
    tier's id map, and which mirror postings contain it."""
    out = []
    for vid in list(vids)[:8]:
        vid = int(vid)
        try:
            rev = fresh.storage.postings_of(vid)
        except Exception as e:  # noqa: BLE001 — forensics must not mask
            rev = f"<{type(e).__name__}: {e}>"
        imap = getattr(fresh, "_id_map", {}).get(vid)
        mirror = []
        idx = getattr(fresh, "index", None)
        if idx is not None:
            try:
                for pid, (ids, _v) in list(idx.postings.items()):
                    if (ids == vid).any():
                        mirror.append(pid)
            except RuntimeError:  # postings dict mutated mid-scan
                mirror = ["<concurrently-changed>"]
        out.append(f"vid {vid}: storage={rev} map={imap} mirror={mirror}")
    return "; ".join(out)


def test_concurrent_search_update_compact(tmp_path):
    rng = np.random.default_rng(0)
    data = 2.0 * rng.standard_normal((200, DIM)).astype(np.float32)
    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": 4,
                "desired_cluster_size": 40,
                "rng_seed": 42,
            },
            "output_path": str(tmp_path / "cc"),
        }
    )
    SpannIndexBuilder(cfg).with_data(data).build(save=True)
    fresh = LazySpFreshIndex(
        cfg.output_path,
        lire_config=LireConfig(max_partition_size=80, min_partition_size=2),
    )
    anchor_vid, anchor_vec = 0, data[0]
    stop = threading.Event()
    errors = []
    deleted_lock = threading.Lock()
    deleted_confirmed: set = set()  # vids whose delete() has RETURNED

    def searcher(qsel=(5, 9)):
        q = np.stack([anchor_vec] + [data[j] for j in qsel])
        try:
            while not stop.is_set():
                # Snapshot BEFORE the search: only vids whose delete
                # returned before this search STARTED must be absent (an
                # overlapping delete may legitimately race the search).
                with deleted_lock:
                    pre = set(deleted_confirmed)
                ids, _ = fresh.search(q, 8, nprobe=fresh.num_clusters)
                bad = set(ids.reshape(-1).tolist()) & pre
                if bad:
                    errors.append(
                        f"deleted vids in results: {bad} | "
                        f"{_vid_state(fresh, bad)}"
                    )
                    return
                if anchor_vid not in ids[0]:
                    errors.append(
                        "anchor vid vanished from its own query | "
                        f"{_vid_state(fresh, [anchor_vid])}"
                    )
                    return
        except Exception as e:  # noqa: BLE001
            errors.append(
                f"searcher raised: {type(e).__name__}: {e}\n"
                f"{traceback.format_exc()}"
            )

    def mutator():
        r = np.random.default_rng(1)
        next_vid = 20_000
        mine = []
        try:
            while not stop.is_set():
                if mine and r.random() < 0.45:
                    if len(mine) >= 3 and r.random() < 0.3:
                        # Batch form: exercises the zero-hit-round and
                        # stale-mirror-sweep paths delete_batch owns.
                        vids = [mine.pop(int(r.integers(len(mine))))
                                for _ in range(3)]
                        n_del = fresh.delete_batch(vids)
                        confirmed = [v for v in vids
                                     if not fresh.storage.postings_of(v)]
                        if n_del < len(vids) and len(confirmed) == len(vids):
                            errors.append(
                                f"delete_batch({vids}) undercounted {n_del} | "
                                f"{_vid_state(fresh, vids)}"
                            )
                            return
                        with deleted_lock:
                            deleted_confirmed.update(confirmed)
                        mine.extend(v for v in vids if v not in confirmed)
                        continue
                    vid = mine.pop(int(r.integers(len(mine))))
                    for attempt in range(20):
                        try:
                            fresh.delete(vid)
                            break
                        except LireStorageError:
                            continue  # documented retry contract
                    else:
                        errors.append(
                            f"delete({vid}) never converged | "
                            f"{_vid_state(fresh, [vid])}"
                        )
                        return
                    with deleted_lock:
                        deleted_confirmed.add(vid)
                else:
                    v = 2.0 * r.standard_normal(DIM).astype(np.float32)
                    fresh.insert(v, next_vid)
                    mine.append(next_vid)
                    next_vid += 1
        except Exception as e:  # noqa: BLE001
            errors.append(
                f"mutator raised: {type(e).__name__}: {e}\n"
                f"{traceback.format_exc()}"
            )

    def compactor():
        try:
            while not stop.is_set():
                fresh.compact()
                stop.wait(0.25)
        except Exception as e:  # noqa: BLE001
            errors.append(
                f"compactor raised: {type(e).__name__}: {e}\n"
                f"{traceback.format_exc()}"
            )

    threads = [
        threading.Thread(target=searcher),
        threading.Thread(target=searcher, kwargs={"qsel": (17, 42)}),
        threading.Thread(target=mutator),
        threading.Thread(target=compactor),
    ]
    for t in threads:
        t.start()
    stop_timer = threading.Timer(8.0, stop.set)
    stop_timer.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive(), "stress thread wedged (deadlock)"
    stop_timer.cancel()
    assert not errors, errors
    # Post-stress coherence: flushed state serves; anchor still exact.
    fresh.flush()
    ids, d = fresh.search(anchor_vec[None, :], 1, nprobe=fresh.num_clusters)
    assert int(ids[0, 0]) == anchor_vid
    assert float(d[0, 0]) < 1e-4
    with deleted_lock:
        for vid in list(deleted_confirmed)[:10]:
            assert fresh.storage.postings_of(vid) == []
    fresh.close()


def test_concurrent_search_update_ram_tier(tmp_path):
    """Same stress on the in-RAM SpFreshIndex (search mirror + storage):
    searcher vs mutator under continuous background splits."""
    from spfresh_tpu.lire.fresh import SpFreshIndex

    rng = np.random.default_rng(0)
    data = 2.0 * rng.standard_normal((200, DIM)).astype(np.float32)
    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": 4,
                "desired_cluster_size": 40,
                "rng_seed": 42,
            },
            "output_path": str(tmp_path / "ram_idx"),
        }
    )
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    fresh = SpFreshIndex(
        index, str(tmp_path / "ram_lire"),
        LireConfig(max_partition_size=80, min_partition_size=2),
    )
    anchor_vid, anchor_vec = 0, data[0]
    stop = threading.Event()
    errors = []
    deleted_lock = threading.Lock()
    deleted_confirmed: set = set()

    def searcher():
        q = np.stack([anchor_vec, data[5]])
        try:
            while not stop.is_set():
                with deleted_lock:
                    pre = set(deleted_confirmed)
                ids, _ = fresh.search(q, 8, nprobe=index.num_clusters,
                                      engine="csr")
                bad = set(ids.reshape(-1).tolist()) & pre
                if bad:
                    errors.append(
                        f"deleted vids in results: {bad} | "
                        f"{_vid_state(fresh, bad)}"
                    )
                    return
                if anchor_vid not in ids[0]:
                    errors.append(
                        "anchor vid vanished | "
                        f"{_vid_state(fresh, [anchor_vid])}"
                    )
                    return
        except Exception as e:  # noqa: BLE001
            errors.append(
                f"searcher raised: {type(e).__name__}: {e}\n"
                f"{traceback.format_exc()}"
            )

    def mutator():
        from spfresh_tpu.lire import LireStorageError

        r = np.random.default_rng(1)
        next_vid = 30_000
        mine = []
        try:
            while not stop.is_set():
                if mine and r.random() < 0.45:
                    if len(mine) >= 3 and r.random() < 0.3:
                        vids = [mine.pop(int(r.integers(len(mine))))
                                for _ in range(3)]
                        n_del = fresh.delete_batch(vids)
                        confirmed = [v for v in vids
                                     if not fresh.storage.postings_of(v)]
                        if n_del < len(vids) and len(confirmed) == len(vids):
                            errors.append(
                                f"delete_batch({vids}) undercounted {n_del} | "
                                f"{_vid_state(fresh, vids)}"
                            )
                            return
                        with deleted_lock:
                            deleted_confirmed.update(confirmed)
                        mine.extend(v for v in vids if v not in confirmed)
                        continue
                    vid = mine.pop(int(r.integers(len(mine))))
                    for _ in range(20):
                        try:
                            fresh.delete(vid)
                            break
                        except LireStorageError:
                            continue
                    else:
                        errors.append(
                            f"delete({vid}) never converged | "
                            f"{_vid_state(fresh, [vid])}"
                        )
                        return
                    with deleted_lock:
                        deleted_confirmed.add(vid)
                else:
                    v = 2.0 * r.standard_normal(DIM).astype(np.float32)
                    fresh.insert(v, next_vid)
                    mine.append(next_vid)
                    next_vid += 1
        except Exception as e:  # noqa: BLE001
            errors.append(
                f"mutator raised: {type(e).__name__}: {e}\n"
                f"{traceback.format_exc()}"
            )

    threads = [threading.Thread(target=searcher),
               threading.Thread(target=mutator)]
    for t in threads:
        t.start()
    timer = threading.Timer(6.0, stop.set)
    timer.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive(), "stress thread wedged"
    timer.cancel()
    assert not errors, errors
    fresh.flush()
    ids, d = fresh.search(anchor_vec[None, :], 1, nprobe=index.num_clusters,
                          engine="csr")
    assert int(ids[0, 0]) == anchor_vid and float(d[0, 0]) < 1e-4
    fresh.close()
