"""Multi-chip SPANN search over a ``jax.sharding.Mesh``.

The reference is a single-process library whose only fan-out is rayon threads
(SURVEY.md section 2, "Parallelism strategies").  Here the scale-out axis
is the vector corpus: posting lists and their centroids are sharded across
devices; every device scans its centroid shard, reranks its local posting
lists, and the per-shard top-k results meet in an ``all_gather`` followed
by a replicated merge (SURVEY.md section 5, "Distributed communication
backend").  No custom transport — XLA's collectives carry the merge (NCCL
over NVLink on a multi-GPU host).

Layout: clusters are dealt to shards in size-balanced round-robin order; each
shard's CSR block is padded to the same static shape so one program serves
all shards under ``shard_map``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spfresh_tpu.index.spann import (
    SpannIndex,
    _cast_storage_np,
    _ids_i32,
    _max_multiplicity,
    _round_up,
)
from spfresh_tpu.ops.distances import (
    pairwise_distance,
    rowwise_distance,
    slab_distances,
)
from spfresh_tpu.ops.topk import centroid_topk, smallest_k, smallest_k_unique

_F32_EPS = float(np.finfo(np.float32).eps)


def default_mesh(axis: str = "shard", devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


@dataclasses.dataclass
class ShardedView:
    """Per-shard padded CSR blocks, stacked on a leading shard axis."""

    centroids: jax.Array  # (S, Cs, d)
    cent_valid: jax.Array  # (S, Cs)
    offsets: jax.Array  # (S, Cs)
    lens: jax.Array  # (S, Cs)
    ids: jax.Array  # (S, Ps)
    vectors: jax.Array  # (S, Ps, d)
    scales: jax.Array  # (S, Cs) f32 per-posting dequant scales (1.0 = none)
    pad: int
    num_shards: int
    max_dup: int = 8


@dataclasses.dataclass
class ShardedPaddedView:
    """Per-shard SLAB blocks for the slab engine: each shard's posting
    lists are contiguous (pad, d_pad) slabs of its local (Cs, pad, d_pad)
    array, so the rerank reads whole slabs on every device.

    Update-in-place, like the single-device PaddedView: ``cluster_rows`` maps
    cid -> (shard, row); ``free_rows`` holds each shard's unassigned slab
    rows; ``snapshot`` remembers each posting's ids at the last refresh so
    streaming inserts take the append fast path (scatter only the new member
    rows).  Row ``scratch_row`` of EVERY shard is reserved as a write sink
    for batch-padding dummies (cent_valid False, len 0 forever), which keeps
    every scatter a fixed shape per shard without read-modify-write masking."""

    centroids: jax.Array  # (S, Cs, d_pad)
    cent_valid: jax.Array  # (S, Cs)
    lens: jax.Array  # (S, Cs)
    ids2d: jax.Array  # (S, Cs, pad) int32
    vectors3d: jax.Array  # (S, Cs, pad, d_pad)
    scales: jax.Array  # (S, Cs) f32 per-posting dequant scales (1.0 = none)
    pad: int
    d_pad: int
    num_shards: int
    max_dup: int = 8
    scratch_row: int = 0
    scales_host: Optional[np.ndarray] = None
    cluster_rows: Dict[int, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    free_rows: List[List[int]] = dataclasses.field(default_factory=list)
    snapshot: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)


class ShardedSpannIndex:
    """Data-sharded SPANN search: local scan + rerank per chip, collective
    top-k merge over the mesh axis."""

    def __init__(self, index: SpannIndex, mesh: Optional[Mesh] = None, axis: str = "shard",
                 engine: str = "auto"):
        """``engine``: "auto" serves the layout the wrapped index's
        ``search_layout`` picks (CSR until its first live update, padded
        slabs after it); "slab" or "csr" forces one, to compare the two."""
        self.index = index
        self.metric = index.metric
        self.mesh = mesh if mesh is not None else default_mesh(axis)
        self.axis = self.mesh.axis_names[0]
        self.num_shards = self.mesh.devices.size
        if engine not in ("auto", "slab", "csr"):
            raise ValueError(f"unknown engine {engine!r}")
        self._engine = engine
        self._view: Optional[ShardedView] = None
        self._padded: Optional[ShardedPaddedView] = None
        self._view_gen = -1  # index._gen at view build; stale views rebuild
        self._padded_gen = -1

    @property
    def engine(self) -> str:
        """The layout the next search reads: "slab" or "csr"."""
        if self._engine == "auto":
            return self.index.search_layout()
        return self._engine

    # -- sharded layout ----------------------------------------------------

    def _deal(self):
        """Size-balanced deal: biggest cluster to the currently-lightest
        shard.  Returns (per_shard cid lists, loads, max posting length)."""
        idx = self.index
        if not idx.postings:
            raise ValueError("index is empty")
        S = self.num_shards
        cids = sorted(idx.postings, key=lambda c: -len(idx.postings[c][0]))
        load = [0] * S
        per_shard: List[List[int]] = [[] for _ in range(S)]
        for c in cids:
            s = int(np.argmin(load))
            per_shard[s].append(c)
            load[s] += len(idx.postings[c][0])
        max_len = max(len(idx.postings[c][0]) for c in cids)
        all_ids = np.concatenate([idx.postings[c][0] for c in cids])
        return per_shard, load, max_len, all_ids

    def _build_view(self) -> ShardedView:
        idx = self.index
        S = self.num_shards
        d = idx.dim
        per_shard, load, max_len, all_ids = self._deal()
        Cs = max(8, _round_up(max(len(g) for g in per_shard), 8))
        pad = max(8, _round_up(max(1, max_len), 8))
        Ps = max(8, _round_up(max(load), 8))
        cent = np.zeros((S, Cs, d), np.float32)
        valid = np.zeros((S, Cs), bool)
        offsets = np.zeros((S, Cs), np.int32)
        lens = np.zeros((S, Cs), np.int32)
        flat_ids = np.full((S, Ps), -1, np.int32)
        flat_vecs = np.zeros((S, Ps, d), np.float32)
        for s, group in enumerate(per_shard):
            pos = 0
            for row, c in enumerate(group):
                pids, pvecs = idx.postings[c]
                m = len(pids)
                cent[s, row] = idx.centroids[c]
                valid[s, row] = True
                offsets[s, row] = pos
                lens[s, row] = m
                flat_ids[s, pos : pos + m] = _ids_i32(pids)
                flat_vecs[s, pos : pos + m] = pvecs
                pos += m
        spec = NamedSharding(self.mesh, P(self.axis))
        # device_put straight from numpy: staging through jnp.asarray would
        # commit each array to the *default* backend first — wrong placement,
        # and a hard failure for a CPU mesh when another backend is default.
        sd = idx.policy.storage_dtype
        quant = idx.policy.quantized
        scales = np.ones((S, Cs), np.float32)
        if quant:
            from spfresh_tpu.core.dtypes import quant_scale_for, quantize_np

            vec_cast = np.zeros_like(flat_vecs, dtype=np.int8)
            for s_i, group in enumerate(per_shard):
                pos = 0
                for row, c in enumerate(group):
                    m = len(idx.postings[c][0])
                    if m:
                        res = (
                            np.asarray(idx.postings[c][1], np.float32)
                            - idx.centroids[c][None, :]
                        )
                        scales[s_i, row] = quant_scale_for(res)
                        vec_cast[s_i, pos : pos + m] = quantize_np(
                            res, scales[s_i, row]
                        )
                    pos += m
        else:
            vec_cast = flat_vecs.astype(sd)
        cent_c = cent.astype(np.float32) if quant else cent.astype(sd)
        self._view = ShardedView(
            centroids=jax.device_put(cent_c, spec),
            cent_valid=jax.device_put(valid, spec),
            offsets=jax.device_put(offsets, spec),
            lens=jax.device_put(lens, spec),
            ids=jax.device_put(flat_ids, spec),
            vectors=jax.device_put(vec_cast, spec),
            scales=jax.device_put(scales, spec),
            pad=pad,
            num_shards=S,
            max_dup=_max_multiplicity(all_ids),
        )
        self._view_gen = idx._gen
        return self._view

    def view(self) -> ShardedView:
        if self._view is None or self._view_gen != self.index._gen:
            self._build_view()
        return self._view

    def padded_view(self) -> ShardedPaddedView:
        idx = self.index
        if self._padded is not None:
            if self._padded_gen == idx._gen:
                return self._padded
            if idx._bulk_gen <= self._padded_gen:
                dirty = {
                    c for c, g in idx._mutated_gen.items() if g > self._padded_gen
                }
                if self._apply_padded_updates(dirty):
                    self._padded_gen = idx._gen
                    return self._padded
        S = self.num_shards
        d = idx.dim
        d_pad = max(128, _round_up(d, 128))
        per_shard, _, max_len, all_ids = self._deal()
        # Row headroom for live updates (splits/new postings) + 1 reserved
        # scratch row per shard (the write sink for batch-padding dummies).
        occ = max(len(g) for g in per_shard)
        Cs = max(8, _round_up(occ + max(8, occ // 4) + 1, 8))
        # Slot headroom like the single-device view (slab_growth_slots):
        # zero spare slots would force a full repack + re-upload of the
        # whole sharded view on the FIRST append to the largest posting.
        growth = int(self.index.config.search.slab_growth_slots)
        pad = max(16, _round_up(max(1, max_len) + growth, 16))
        cent = np.zeros((S, Cs, d_pad), np.float32)
        valid = np.zeros((S, Cs), bool)
        lens = np.zeros((S, Cs), np.int32)
        ids2d = np.full((S, Cs, pad), -1, np.int32)
        vecs3d = np.zeros((S, Cs, pad, d_pad), np.float32)
        cluster_rows: Dict[int, Tuple[int, int]] = {}
        snapshot: Dict[int, np.ndarray] = {}
        scratch = Cs - 1
        free_rows = [list(range(len(g), scratch)) for g in per_shard]
        quant = idx.policy.quantized
        scales = np.ones((S, Cs), np.float32)
        from spfresh_tpu.core.dtypes import quant_scale_for

        for s, group in enumerate(per_shard):
            for row, c in enumerate(group):
                pids, pvecs = idx.postings[c]
                m = len(pids)
                cent[s, row, :d] = idx.centroids[c]
                valid[s, row] = True
                lens[s, row] = m
                ids2d[s, row, :m] = _ids_i32(pids)
                if quant:
                    res = np.asarray(pvecs, np.float32) - idx.centroids[c][None, :]
                    vecs3d[s, row, :m, :d] = res
                    if m:
                        scales[s, row] = quant_scale_for(res)
                else:
                    vecs3d[s, row, :m, :d] = pvecs
                cluster_rows[c] = (s, row)
                snapshot[c] = pids
        spec = NamedSharding(self.mesh, P(self.axis))
        sd = idx.policy.storage_dtype
        if quant:
            vec_cast = _cast_storage_np(
                vecs3d, sd, scales[:, :, None, None]
            )
            cent_c = cent.astype(np.float32)
        else:
            vec_cast = vecs3d.astype(sd)
            cent_c = cent.astype(sd)
        self._padded = ShardedPaddedView(
            centroids=jax.device_put(cent_c, spec),
            cent_valid=jax.device_put(valid, spec),
            lens=jax.device_put(lens, spec),
            ids2d=jax.device_put(ids2d, spec),
            vectors3d=jax.device_put(vec_cast, spec),
            scales=jax.device_put(scales, spec),
            pad=pad,
            d_pad=d_pad,
            num_shards=S,
            max_dup=_max_multiplicity(all_ids),
            scratch_row=scratch,
            cluster_rows=cluster_rows,
            free_rows=free_rows,
            snapshot=snapshot,
        )
        self._padded_gen = idx._gen
        return self._padded

    # -- incremental updates (scatter into the sharded view in place) -------
    # (jitted kernels at module level — shared across index instances on the
    # same mesh, like the search kernels)

    def _apply_padded_updates(self, dirty) -> bool:
        """Land ``dirty`` postings in the live sharded view without a repack.
        Mirrors SpannIndex._apply_padded_updates (spann.py): append fast path
        for pure streaming growth, slab rewrite otherwise; new postings take
        a free row on the emptiest shard.  Returns False (caller rebuilds)
        when a posting outgrew the slab width or free rows ran out."""
        view = self._padded
        idx = self.index
        if not dirty:
            return True
        d = idx.dim
        if d is None or d > view.d_pad:
            return False
        for c in dirty:
            if c in idx.postings and len(idx.postings[c][0]) > view.pad:
                return False
        S = view.num_shards
        gen0 = self._padded_gen
        free = [list(f) for f in view.free_rows]
        appends: List[List[Tuple[int, int, np.ndarray, np.ndarray, int]]] = [
            [] for _ in range(S)
        ]  # per shard: (row, old_len, add_ids, add_vecs, new_len)
        append_snap: List[Tuple[int, np.ndarray]] = []  # committed after planning
        rewrites: List[List[int]] = [[] for _ in range(S)]  # cids (or -row-1 frees)
        row_of: Dict[int, Tuple[int, int]] = {}
        for c in sorted(dirty):
            if c in idx.postings:
                ids, vecs = idx.postings[c]
                loc = view.cluster_rows.get(c)
                old = view.snapshot.get(c)
                if (
                    loc is not None
                    and old is not None
                    and idx._centroid_gen.get(c, 0) <= gen0
                    and len(ids) > len(old)
                    and np.array_equal(ids[: len(old)], old)
                    and idx._append_scale_ok(view, loc, c, vecs, len(old))
                ):
                    s, row = loc
                    appends[s].append(
                        (row, len(old), ids[len(old):], vecs[len(old):],
                         len(ids), idx.centroids[c])
                    )
                    # Snapshot mutation DEFERRED: a later free-row exhaustion
                    # returns False, and the caller's repack must not see a
                    # half-planned snapshot (ADVICE r2).
                    append_snap.append((c, ids))
                    continue
                if loc is None:
                    s = int(np.argmax([len(f) for f in free]))
                    if not free[s]:
                        return False
                    loc = (s, free[s].pop())
                row_of[c] = loc
                rewrites[loc[0]].append(c)
            elif c in view.cluster_rows:
                s, row = view.cluster_rows[c]
                row_of[c] = (s, row)
                rewrites[s].append(c)
        for c, ids in append_snap:
            view.snapshot[c] = ids

        sd = idx.policy.storage_dtype
        quant = idx.policy.quantized
        if quant and view.scales_host is None:
            view.scales_host = np.asarray(view.scales).copy()
        dummy_slot = view.scratch_row * view.pad
        if any(appends):
            CH = 1024
            n_chunks = max(
                (sum(len(a[2]) for a in apl) + CH - 1) // CH for apl in appends
            )
            n_chunks = max(1, n_chunks)
            slots = np.full((S, n_chunks * CH), dummy_slot, np.int32)
            vblk = np.zeros((S, n_chunks * CH, view.d_pad), np.float32)
            iblk = np.full((S, n_chunks * CH), -1, np.int32)
            arows = np.full((S, n_chunks * CH), view.scratch_row, np.int32)
            alens = np.zeros((S, n_chunks * CH), np.int32)
            for s, apl in enumerate(appends):
                pos = 0
                for row, old_len, add_ids, add_vecs, _new_len, cent_c in apl:
                    k = len(add_ids)
                    slots[s, pos : pos + k] = row * view.pad + old_len + np.arange(k)
                    if quant:
                        vblk[s, pos : pos + k, :d] = add_vecs - cent_c[None, :]
                    else:
                        vblk[s, pos : pos + k, :d] = add_vecs
                    iblk[s, pos : pos + k] = _ids_i32(add_ids)
                    pos += k
                for j, (row, _, _, _, new_len, _c) in enumerate(apl):
                    arows[s, j] = row
                    alens[s, j] = new_len
            spec = NamedSharding(self.mesh, P(self.axis))
            if quant:
                slot_scale = np.take_along_axis(
                    view.scales_host, slots // view.pad, axis=1
                )[:, :, None]
            v3, i2, ln = view.vectors3d, view.ids2d, view.lens
            for k0 in range(0, n_chunks * CH, CH):
                sl = slice(k0, k0 + CH)
                sc = slot_scale[:, sl] if quant else 1.0
                v3, i2, ln = _scatter_appends_sharded(
                    v3, i2, ln,
                    jax.device_put(slots[:, sl], spec),
                    jax.device_put(_cast_storage_np(vblk[:, sl], sd, sc), spec),
                    jax.device_put(iblk[:, sl], spec),
                    jax.device_put(arows[:, sl], spec),
                    jax.device_put(alens[:, sl], spec),
                    mesh=self.mesh, axis=self.axis,
                )
            view.vectors3d, view.ids2d, view.lens = v3, i2, ln

        if row_of:
            RB = 8
            n_chunks = max(1, max((len(r) + RB - 1) // RB for r in rewrites))
            rows = np.full((S, n_chunks * RB), view.scratch_row, np.int32)
            vblk = np.zeros((S, n_chunks * RB, view.pad, view.d_pad), np.float32)
            iblk = np.full((S, n_chunks * RB, view.pad), -1, np.int32)
            lblk = np.zeros((S, n_chunks * RB), np.int32)
            cblk = np.zeros((S, n_chunks * RB, view.d_pad), np.float32)
            sclblk = np.ones((S, n_chunks * RB), np.float32)
            vldblk = np.zeros((S, n_chunks * RB), bool)
            from spfresh_tpu.core.dtypes import quant_scale_for

            for s, cids in enumerate(rewrites):
                for j, c in enumerate(cids):
                    _, row = row_of[c]
                    rows[s, j] = row
                    if c in idx.postings:
                        ids, vecs = idx.postings[c]
                        m = len(ids)
                        if quant:
                            vblk[s, j, :m, :d] = (
                                vecs - idx.centroids[c][None, :]
                            )
                            if m:
                                sclblk[s, j] = quant_scale_for(
                                    vblk[s, j, :m, :d]
                                )
                        else:
                            vblk[s, j, :m, :d] = vecs
                        iblk[s, j, :m] = _ids_i32(ids)
                        lblk[s, j] = m
                        cblk[s, j, :d] = idx.centroids[c]
                        vldblk[s, j] = True
            spec = NamedSharding(self.mesh, P(self.axis))
            v3, i2, ln = view.vectors3d, view.ids2d, view.lens
            ce, vl, sc_d = view.centroids, view.cent_valid, view.scales
            for k0 in range(0, n_chunks * RB, RB):
                sl = slice(k0, k0 + RB)
                v3, i2, ln, ce, vl, sc_d = _scatter_rows_sharded(
                    v3, i2, ln, ce, vl, sc_d,
                    jax.device_put(rows[:, sl], spec),
                    jax.device_put(_cast_storage_np(
                        vblk[:, sl], sd, sclblk[:, sl, None, None]
                    ), spec),
                    jax.device_put(iblk[:, sl], spec),
                    jax.device_put(lblk[:, sl], spec),
                    jax.device_put(
                        cblk[:, sl].astype(np.float32)
                        if quant else cblk[:, sl].astype(sd),
                        spec,
                    ),
                    jax.device_put(vldblk[:, sl], spec),
                    jax.device_put(sclblk[:, sl], spec),
                    mesh=self.mesh, axis=self.axis,
                )
            view.vectors3d, view.ids2d, view.lens = v3, i2, ln
            view.centroids, view.cent_valid, view.scales = ce, vl, sc_d
            if quant and view.scales_host is not None:
                np.put_along_axis(view.scales_host, rows, sclblk, axis=1)
            view.free_rows = free
            for c, (s, row) in row_of.items():
                if c in idx.postings:
                    view.cluster_rows[c] = (s, row)
                    view.snapshot[c] = idx.postings[c][0]
                else:
                    view.cluster_rows.pop(c, None)
                    view.snapshot.pop(c, None)
                    view.free_rows[s].append(row)

        view.max_dup = max(view.max_dup, idx._dedup_bound())
        return True

    # -- search ------------------------------------------------------------
    # The jitted kernels live at MODULE level, keyed on (mesh, axis, metric,
    # pad, shapes) — constructing a second ShardedSpannIndex on the same mesh
    # reuses the compiled programs instead of recompiling per instance.

    def search(
        self, queries, k: int, nprobe: Optional[int] = None,
        prune_factor: Optional[float] = None, batch_size: int = 1024,
        nprobe_mode: str = "per_shard",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched multi-chip search.

        ``nprobe_mode``:

        * ``"per_shard"`` (default) — every shard probes its local top
          ``nprobe`` lists: S shards probe S*nprobe lists in total, a safe
          superset of the single-chip semantics (more recall per nprobe,
          not comparable across mesh sizes).
        * ``"global"`` — the mesh probes the GLOBAL top ``nprobe`` lists:
          per-shard centroid distances all_gather, the global nprobe-th
          smallest becomes the probe threshold, and every local list past
          it is masked out.  Candidate semantics (and recall) are exactly
          the single-chip index's at equal nprobe — the apples-to-apples
          mode for cross-mesh-size comparisons (VERDICT r2 item 7).  Ties
          at the threshold keep all tied lists (a superset, like top_k).

        ``prune_factor`` enables reference-style dynamic pruning against
        the global nearest-centroid distance."""
        if nprobe_mode not in ("per_shard", "global"):
            raise ValueError(f"unknown nprobe_mode {nprobe_mode!r}")
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if nprobe is None:
            nprobe = self.index.config.search.nprobe or k
        if prune_factor is None:
            prune_factor = self.index.config.search.prune_factor
        prune = prune_factor is not None
        global_np = nprobe_mode == "global"
        qspec = NamedSharding(self.mesh, P())
        pf = jax.device_put(
            np.float32(prune_factor if prune else 0.0), qspec
        )
        out_i, out_d = [], []
        S = self.num_shards
        engine = self.engine
        if engine == "slab":
            if self._engine == "auto":
                self._view = None  # the CSR snapshot is no longer served
            view = self.padded_view()
            local_np = max(1, min(int(nprobe), int(view.centroids.shape[1])))
            # The threshold depth is the REQUESTED total-probe budget; the
            # local scan depth is clamped to the shard's list capacity (the
            # global top-nprobe holds at most nprobe lists per shard, so
            # local_np = min(nprobe, Cs) always suffices).
            global_k = max(1, min(int(nprobe), S * local_np)) if global_np else 0
            nprobe = local_np
            # Bound each device's (batch, nprobe, pad) f32 distance block to
            # ~1 GB.
            batch_size = min(
                batch_size, max(1, (1 << 30) // (nprobe * view.pad * 4))
            )
            qpad = np.zeros((queries.shape[0], view.d_pad), np.float32)
            qpad[:, : self.index.dim] = queries
            arrays = (
                view.centroids, view.cent_valid, view.lens,
                view.ids2d, view.vectors3d, view.scales,
            )
            for s in range(0, queries.shape[0], batch_size):
                qi, qd = _sharded_search_padded(
                    jax.device_put(qpad[s : s + batch_size], qspec),
                    arrays, pf,
                    mesh=self.mesh, axis=self.axis, metric=self.metric,
                    pad=view.pad, k=int(k), nprobe=nprobe, prune=prune,
                    global_k=global_k,
                    max_dup=view.max_dup,
                )
                out_i.append(np.asarray(qi))
                out_d.append(np.asarray(qd))
        else:
            view = self.view()
            local_np = max(1, min(int(nprobe), int(view.centroids.shape[1])))
            global_k = max(1, min(int(nprobe), S * local_np)) if global_np else 0
            nprobe = local_np
            arrays = (
                view.centroids, view.cent_valid, view.offsets,
                view.lens, view.ids, view.vectors, view.scales,
            )
            for s in range(0, queries.shape[0], batch_size):
                qi, qd = _sharded_search_xla(
                    jax.device_put(queries[s : s + batch_size], qspec),
                    arrays, pf,
                    mesh=self.mesh, axis=self.axis, metric=self.metric,
                    pad=view.pad, k=int(k), nprobe=nprobe, prune=prune,
                    global_k=global_k, max_dup=view.max_dup,
                )
                out_i.append(np.asarray(qi))
                out_d.append(np.asarray(qd))
        return np.concatenate(out_i).astype(np.int64), np.concatenate(out_d)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "metric", "pad", "k", "nprobe", "prune",
        "global_k", "max_dup",
    ),
)
def _sharded_search_xla(
    queries, view_arrays, prune_factor, *, mesh, axis, metric, pad,
    k: int, nprobe: int, prune: bool, global_k: int, max_dup: int,
):
    """Gather-engine multi-chip search, compiled per (mesh, metric, shape) —
    NOT per index instance."""
    centroids, cent_valid, offsets, lens, ids, vectors, pscales = view_arrays

    def shard_fn(q, pf, cent, cvalid, offs, lns, pids, pvecs, pscl):
        # Drop the unit shard axis of each local block.
        cent, cvalid, offs, lns, pids, pvecs, pscl = (
            a[0] for a in (cent, cvalid, offs, lns, pids, pvecs, pscl)
        )
        raw_d, cand_ids, local_cd = _local_candidates(
            q, cent, cvalid, offs, lns, pids, pvecs, pscl,
            k=k, nprobe=nprobe, pad=pad, metric=metric,
            axis=axis if global_k else None, global_k=global_k,
        )
        if prune:
            # Reference-style dynamic pruning against the GLOBAL nearest
            # centroid distance: pmin over shards keeps the threshold
            # identical to the single-chip semantics.
            global_cd = jax.lax.pmin(local_cd, axis)  # (Q,)
            thr = pf.astype(raw_d.dtype) * (global_cd + _F32_EPS)
            raw_d = jnp.where(raw_d <= thr[:, None], raw_d, jnp.inf)
        # Local DISTINCT top-k: duplicates of one point (replicas in two
        # postings on the same shard) must not evict a true neighbor from
        # the shard's k slots — with dedup, any global top-k point living
        # on this shard provably survives into the local top-k.
        local_d, local_i = smallest_k_unique(
            raw_d, cand_ids, min(k, raw_d.shape[1]), max_dup=max_dup
        )
        return _merge_topk(local_d, local_i, axis, k, max_dup)

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis), P(axis),
                  P(axis), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )(queries, prune_factor, centroids, cent_valid, offsets, lens, ids,
      vectors, pscales)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "metric", "pad", "k", "nprobe", "prune",
        "global_k", "max_dup",
    ),
)
def _sharded_search_padded(
    queries, view_arrays, prune_factor, *, mesh, axis, metric, pad,
    k: int, nprobe: int, prune: bool, global_k: int, max_dup: int,
):
    """Slab engine per device: local centroid scan, gather + rerank of
    whole posting slabs (``slab_distances``) on each shard's slab block,
    distinct local top-k, collective merge.  Compiled per (mesh, metric,
    shape)."""
    centroids, cvalid, lens, ids2d, vecs3d, pscales = view_arrays

    def shard_fn(q, pf, cent, cvalid_, lns, pids2d, pvecs3d, pscl):
        cent, cvalid_, lns, pids2d, pvecs3d, pscl = (
            a[0] for a in (cent, cvalid_, lns, pids2d, pvecs3d, pscl)
        )
        Q = q.shape[0]
        qf = q.astype(cent.dtype)
        cent_d, rows = centroid_topk(qf, cent, cvalid_, nprobe, metric)
        if global_k:
            cent_d = _global_probe_mask(cent_d, global_k, axis)
        if pvecs3d.dtype == jnp.int8:
            qc = (
                q.astype(jnp.float32)[:, None, :]
                - cent[rows].astype(jnp.float32)
            )
            d = slab_distances(
                q, rows, pvecs3d, metric, scales=pscl[rows],
                centered_queries=qc,
            )
        else:
            d = slab_distances(q, rows, pvecs3d, metric)  # (Q, nprobe, pad)
        ar = jnp.arange(pad, dtype=jnp.int32)
        valid = (ar < lns[rows][..., None]) & jnp.isfinite(cent_d)[..., None]
        cand_ids = jnp.where(valid, pids2d[rows], -1)
        d = jnp.where(valid, d, jnp.inf)
        n_cand = nprobe * pad
        raw_d = d.reshape(Q, n_cand)
        cand_ids = cand_ids.reshape(Q, n_cand)
        if n_cand < k:
            padc = k - n_cand
            raw_d = jnp.concatenate(
                [raw_d, jnp.full((Q, padc), jnp.inf, raw_d.dtype)], axis=1
            )
            cand_ids = jnp.concatenate(
                [cand_ids, jnp.full((Q, padc), -1, cand_ids.dtype)], axis=1
            )
        if prune:
            global_cd = jax.lax.pmin(cent_d[:, 0], axis)
            thr = pf.astype(raw_d.dtype) * (global_cd + _F32_EPS)
            raw_d = jnp.where(raw_d <= thr[:, None], raw_d, jnp.inf)
        local_d, local_i = smallest_k_unique(
            raw_d, cand_ids, min(k, raw_d.shape[1]), max_dup=max_dup
        )
        return _merge_topk(local_d, local_i, axis, k, max_dup)

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis), P(axis),
                  P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )(queries, prune_factor, centroids, cvalid, lens, ids2d, vecs3d, pscales)


def _global_probe_mask(cent_d, global_k: int, axis: str):
    """Global-nprobe thresholding: all_gather each shard's local top-nprobe
    centroid distances, find the global nprobe-th smallest per query, and
    mask (to inf) every local probe past it.  Downstream validity tests are
    ``isfinite(cent_d)``, so masked probes contribute no candidates — the
    candidate set equals the single-chip index's at the same nprobe (ties
    at the threshold keep all tied lists).  Slab reads still run at the
    per-shard depth; the saving here is SEMANTIC comparability, not
    bandwidth."""
    all_cd = jax.lax.all_gather(cent_d, axis)  # (S, Q, local_depth)
    S, Q = all_cd.shape[0], all_cd.shape[1]
    merged = jnp.moveaxis(all_cd, 0, 1).reshape(Q, S * cent_d.shape[1])
    kth = -jax.lax.top_k(-merged, global_k)[0][:, -1]  # (Q,)
    return jnp.where(cent_d <= kth[:, None], cent_d, jnp.inf)


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis"), donate_argnums=(0, 1, 2)
)
def _scatter_appends_sharded(
    v3, i2, ln, slots, vblk, iblk, rows, lens, *, mesh, axis
):
    """Append-path scatter: per shard, write B new member rows into the
    flattened (Cs*pad, d_pad) slab space and refresh the touched lens."""

    def fn(v3, i2, ln, slots, vblk, iblk, rows, lens):
        v3l = v3[0]
        Cs, pad, dp = v3l.shape
        flat_v = v3l.reshape(Cs * pad, dp).at[slots[0]].set(vblk[0])
        flat_i = i2[0].reshape(Cs * pad).at[slots[0]].set(iblk[0])
        lnl = ln[0].at[rows[0]].set(lens[0])
        return (
            flat_v.reshape(1, Cs, pad, dp),
            flat_i.reshape(1, Cs, pad),
            lnl[None],
        )

    spec = P(axis)
    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=(spec,) * 8, out_specs=(spec, spec, spec),
        check_vma=False,
    )(v3, i2, ln, slots, vblk, iblk, rows, lens)


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis"), donate_argnums=(0, 1, 2, 3, 4, 5)
)
def _scatter_rows_sharded(
    v3, i2, ln, ce, vl, sc, rows, vblk, iblk, lblk, cblk, vldblk, sblk,
    *, mesh, axis
):
    """Slab-rewrite scatter: per shard, replace whole (pad, d_pad) slabs
    plus their centroid/valid/len/dequant-scale rows."""

    def fn(v3, i2, ln, ce, vl, sc, rows, vblk, iblk, lblk, cblk, vldblk, sblk):
        r = rows[0]
        return (
            v3[0].at[r].set(vblk[0])[None],
            i2[0].at[r].set(iblk[0])[None],
            ln[0].at[r].set(lblk[0])[None],
            ce[0].at[r].set(cblk[0])[None],
            vl[0].at[r].set(vldblk[0])[None],
            sc[0].at[r].set(sblk[0])[None],
        )

    spec = P(axis)
    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=(spec,) * 13, out_specs=(spec,) * 6,
        check_vma=False,
    )(v3, i2, ln, ce, vl, sc, rows, vblk, iblk, lblk, cblk, vldblk, sblk)


def _merge_topk(local_d, local_i, axis: str, k: int, max_dup: int):
    """Collective tail shared by both engines: all_gather every shard's
    distinct local top-k over the mesh axis, merge, dedup replicas across shards."""
    all_d = jax.lax.all_gather(local_d, axis)  # (S, Q, k)
    all_i = jax.lax.all_gather(local_i, axis)
    S, Q = all_d.shape[0], all_d.shape[1]
    merged_d = jnp.moveaxis(all_d, 0, 1).reshape(Q, S * local_d.shape[1])
    merged_i = jnp.moveaxis(all_i, 0, 1).reshape(Q, S * local_i.shape[1])
    vals, out_ids = smallest_k_unique(merged_d, merged_i, k, max_dup=max_dup)
    out_ids = jnp.where(jnp.isfinite(vals), out_ids, -1)
    return out_ids, vals


def _local_candidates(
    q, cent, cvalid, offs, lns, pids, pvecs, pscales, *, k, nprobe, pad,
    metric, axis=None, global_k: int = 0,
):
    """Local (per-shard) probe/gather/rerank: returns the full candidate set
    (d (Q, n_cand), cand_ids (Q, n_cand)) plus the shard's nearest-centroid
    distance (Q,) for global pruning.  ``axis`` non-None enables the
    global-nprobe mask (see _global_probe_mask)."""
    Q = q.shape[0]
    qf = q.astype(cent.dtype)
    Dc = pairwise_distance(qf, cent, metric)
    Dc = jnp.where(cvalid[None, :], Dc, jnp.inf)
    cent_d, cent_i = smallest_k(Dc, nprobe)
    if axis is not None:
        cent_d = _global_probe_mask(cent_d, global_k, axis)
    base = offs[cent_i].astype(jnp.int32)
    ar = jnp.arange(pad, dtype=jnp.int32)
    pos = base[..., None] + ar
    valid = (ar < lns[cent_i][..., None]) & jnp.isfinite(cent_d)[..., None]
    pos = jnp.clip(pos, 0, pvecs.shape[0] - 1)
    cand_vecs = pvecs[pos]
    if pvecs.dtype == jnp.int8:
        # IVF-SQ8 reconstruction x = centroid + scale * residual code.
        cand_vecs = (
            cand_vecs.astype(jnp.float32) * pscales[cent_i][..., None, None]
            + cent[cent_i].astype(jnp.float32)[:, :, None, :]
        )
    cand_ids = jnp.where(valid, pids[pos], -1)
    d = rowwise_distance(cand_vecs, q[:, None, None, :], metric)  # unrounded q
    d = jnp.where(valid, d, jnp.inf)
    n_cand = nprobe * pad
    d = d.reshape(Q, n_cand)
    cand_ids = cand_ids.reshape(Q, n_cand)
    if n_cand < k:
        padc = k - n_cand
        d = jnp.concatenate([d, jnp.full((Q, padc), jnp.inf, d.dtype)], axis=1)
        cand_ids = jnp.concatenate(
            [cand_ids, jnp.full((Q, padc), -1, cand_ids.dtype)], axis=1
        )
    return d, cand_ids, cent_d[:, 0]
