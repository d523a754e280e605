"""End-to-end search on the two posting layouts, on one GPU.

  slab — one padded block per posting, gathered whole (``slab_distances``);
         refreshes in place after live updates;
  csr  — flat CSR postings, gathered per member (``_search_kernel``);
         repacks whole after any change.

Builds the SIFT1M-shape index of ``chip_smoke.py`` phase 1 (Gaussian
mixture, bf16 storage, cluster size 256), finds the smallest ``nprobe`` of
the sweep with recall@10 >= 0.90, then measures two workloads:

* static: ``SpannIndex.search`` over ``--nq`` queries per layout, rounds in
  the order slab csr csr slab, ``--reps`` times (best and median wall);
* live updates: ``SpFreshIndex`` takes ``--rounds`` rounds of ``--batch``
  inserts plus ``flush()``; after each, ``--nq-live`` queries are searched
  on each layout (first order alternating by round), timing the first
  search after the change (view refresh included) and a second one.

Every line carries the card's name and power limit; the last line is JSON.

    python benchmarks/rerank_bench.py [--nprobe 32] [--rounds 0]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from spfresh_tpu.utils.compile_cache import REPO_ROOT, enable_compile_cache  # noqa: E402

enable_compile_cache()

from spfresh_tpu.eval import (  # noqa: E402
    NPROBE_SWEEP,
    mixture_corpus,
    recall_at_k,
    sift1m_config,
)
from spfresh_tpu.index import SpannIndexBuilder, brute_force_search  # noqa: E402
from spfresh_tpu.utils.card import card_name  # noqa: E402

ENGINES = ("slab", "csr")


def timed(index, queries, nprobe, engine, k=10):
    t0 = time.perf_counter()
    ids, _ = index.search(queries, k, nprobe=nprobe, engine=engine)
    return ids, time.perf_counter() - t0


def static_rounds(index, queries, nprobe, gt, reps, say):
    times = {e: [] for e in ENGINES}
    for e in ENGINES:  # compile + recall outside the clock
        ids, secs = timed(index, queries, nprobe, e)
        say(f"static {e}: nprobe={nprobe} first call {secs:.3f} s, recall@10="
            f"{recall_at_k(ids, gt, 10):.4f} ({len(queries)} queries)")
    order = list(ENGINES) + list(reversed(ENGINES))
    for _ in range(reps):
        for e in order:
            times[e].append(timed(index, queries, nprobe, e)[1])
    out = {}
    for e, ts in times.items():
        best, med = min(ts), statistics.median(ts)
        out[e] = {"best_s": best, "median_s": med}
        say(f"static {e}: best {best * 1e3:.3f} ms, median {med * 1e3:.3f} ms "
            f"over {len(ts)} runs, {len(queries) / best:.1f} QPS")
    return out


def live_rounds(index, new, queries, nprobe, rounds, batch, say):
    from spfresh_tpu.lire import LireConfig, SpFreshIndex

    first = {e: [] for e in ENGINES}
    second = {e: [] for e in ENGINES}
    upd = []
    next_id = int(max(int(ids.max()) for ids, _ in index.postings.values())) + 1
    store = tempfile.mkdtemp(dir=os.path.join(REPO_ROOT, ".smoke"))
    with SpFreshIndex(
        index, store, LireConfig(max_partition_size=512, min_partition_size=16)
    ) as fresh:
        for e in ENGINES:  # compile both layouts' update paths
            fresh.search(queries, 10, nprobe=nprobe, engine=e)
        for r in range(rounds):
            vecs = new[r * batch : (r + 1) * batch]
            t0 = time.perf_counter()
            fresh.insert_batch(vecs, np.arange(next_id, next_id + len(vecs)))
            fresh.flush()
            upd.append(time.perf_counter() - t0)
            next_id += len(vecs)
            order = ENGINES if r % 2 == 0 else tuple(reversed(ENGINES))
            for e in order:
                first[e].append(timed(fresh, queries, nprobe, e)[1])
            for e in order:
                second[e].append(timed(fresh, queries, nprobe, e)[1])
            say(f"live round {r}: {len(vecs)} inserts + flush {upd[-1]:.3f} s; "
                + ", ".join(f"{e} first {first[e][-1] * 1e3:.3f} ms / second "
                            f"{second[e][-1] * 1e3:.3f} ms" for e in order))
    shutil.rmtree(store, ignore_errors=True)
    out = {"insert_flush_median_s": statistics.median(upd)}
    for e in ENGINES:
        out[e] = {"first_median_s": statistics.median(first[e]),
                  "second_median_s": statistics.median(second[e])}
        say(f"live {e}: first search after an update batch median "
            f"{out[e]['first_median_s'] * 1e3:.3f} ms, second "
            f"{out[e]['second_median_s'] * 1e3:.3f} ms over {rounds} rounds")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nq", type=int, default=16_384)
    ap.add_argument("--nq-live", type=int, default=1_024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--batch", type=int, default=1_000)
    ap.add_argument("--seed", type=int, default=12345)
    ap.add_argument("--nprobe", type=int, default=None,
                    help="probe count to time (default: the sweep's 0.90 point)")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("rerank_bench: needs a GPU")
    card = card_name()

    def say(msg):
        print(f"[{card}] {msg}", flush=True)

    extra = args.rounds * args.batch
    data, queries = mixture_corpus(args.n + extra, args.nq, 128, seed=args.seed)
    data, new = data[: args.n], data[args.n :]
    t0 = time.perf_counter()
    index = SpannIndexBuilder(sift1m_config("bfloat16")).with_data(data).build(
        save=False)
    say(f"build {args.n} x 128 bf16: {time.perf_counter() - t0:.3f} s, "
        f"{index.num_clusters} clusters")
    _, gt = brute_force_search(data, queries, 10)
    nprobe = args.nprobe
    for npb in NPROBE_SWEEP if nprobe is None else ():
        ids, _ = index.search(queries, 10, nprobe=npb)
        if recall_at_k(ids, gt, 10) >= 0.90:
            nprobe = npb
            break
    if nprobe is None:
        raise SystemExit("recall@10 never reached 0.90")

    result = {"card": card, "nprobe": nprobe, "nq": args.nq,
              "static": static_rounds(index, queries, nprobe, gt, args.reps, say)}
    if args.rounds:
        os.makedirs(os.path.join(REPO_ROOT, ".smoke"), exist_ok=True)
        result["live"] = live_rounds(
            index, new, queries[: args.nq_live], nprobe, args.rounds,
            args.batch, say)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
