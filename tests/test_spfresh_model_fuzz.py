"""Model-based fuzz of the in-RAM SpFresh stack (round 4).

Sibling of tests/test_fresh_model_fuzz.py for the RAM tier: random
insert / insert_batch / delete / delete_batch / flush sequences run
against ``SpFreshIndex`` (LireStorage + the in-RAM SpannIndex search
MIRROR + protocol + pipeline) while a dict ``vid -> vector`` tracks the
expected live set.  After ``flush()`` three states must agree with the
model: the storage live set, the search mirror (``index.postings``), and
full-probe self-query results."""

import numpy as np
import os

_STEPS = int(os.environ.get("SPF_FUZZ_STEPS", "150"))  # idle grinds go deeper; CI default unchanged

import pytest

from spfresh_tpu.index import Config, SpannIndexBuilder
from spfresh_tpu.lire import LireConfig
from spfresh_tpu.lire.fresh import SpFreshIndex

DIM = 8


def _storage_live(storage):
    out = {}
    for pid in storage.posting_ids():
        ids, vecs, _ = storage.get_posting(pid)
        for vid, vec in zip(ids, vecs):
            out[int(vid)] = np.asarray(vec, np.float32)
    return out


def _mirror_live(index):
    out = {}
    for pid, (ids, vecs) in index.postings.items():
        for vid, vec in zip(ids, np.asarray(vecs, np.float32)):
            out[int(vid)] = vec
    return out


def _check(fresh, model, deleted, ctx):
    fresh.flush()
    for name, live in (
        ("storage", _storage_live(fresh.storage)),
        ("mirror", _mirror_live(fresh.index)),
    ):
        assert set(live) == set(model), (
            f"{ctx} [{name}]: missing={set(model) - set(live)} "
            f"extra={set(live) - set(model)}"
        )
        assert not (set(live) & deleted), f"{ctx} [{name}]: resurrected"
    probe = list(model.items())[:4]
    if probe:
        q = np.stack([v for _, v in probe])
        ids, d = fresh.search(q, 1, nprobe=fresh.index.num_clusters,
                              engine="csr")
        for r, (vid, _) in enumerate(probe):
            assert int(ids[r, 0]) == vid, f"{ctx}: self-query missed"
            assert float(d[r, 0]) < 1e-4, ctx


@pytest.mark.parametrize("seed", [0, 1])
def test_spfresh_model_fuzz(tmp_path, seed):
    rng = np.random.default_rng(4000 + seed)
    n = 150
    data = 2.0 * rng.standard_normal((n, DIM)).astype(np.float32)
    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": 4,
                "desired_cluster_size": 30,
                "rng_seed": 42,
                "max_replicas": 2,
            },
            "output_path": str(tmp_path / f"sf{seed}"),
        }
    )
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    fresh = SpFreshIndex(
        index, str(tmp_path / "lire"),
        LireConfig(max_partition_size=60, min_partition_size=2),
    )
    model = _storage_live(fresh.storage)
    deleted: set = set()
    next_vid = 10_000
    try:
        for step in range(_STEPS):
            op = rng.choice(
                ["insert", "insert_batch", "delete", "delete_batch"],
                p=[0.4, 0.2, 0.27, 0.13],
            )
            if op == "insert":
                v = 2.0 * rng.standard_normal(DIM).astype(np.float32)
                fresh.insert(v, next_vid)
                model[next_vid] = v
                next_vid += 1
            elif op == "insert_batch":
                kk = int(rng.integers(2, 12))
                vs = 2.0 * rng.standard_normal((kk, DIM)).astype(np.float32)
                vids = list(range(next_vid, next_vid + kk))
                fresh.insert_batch(vs, vids)
                for vid, v in zip(vids, vs):
                    model[vid] = v
                next_vid += kk
            elif op == "delete" and model:
                vid = int(rng.choice(sorted(model)))
                fresh.delete(vid)
                model.pop(vid)
                deleted.add(vid)
            elif op == "delete_batch" and model:
                vids = [int(v) for v in rng.permutation(sorted(model))[:4]]
                fresh.delete_batch(vids)
                for vid in vids:
                    model.pop(vid)
                    deleted.add(vid)
            if step % 15 == 14:
                _check(fresh, model, deleted, f"seed {seed} step {step}")
        _check(fresh, model, deleted, f"seed {seed} final")
    finally:
        fresh.close()
