"""Disk-backed lazy search — the reference's memory model, streamed to the device.

The reference keeps only the centroid tree + manifest resident and pages
posting lists from disk per query (SURVEY.md section 3.3 "Lazy design";
spann_index.rs:169).  This mode reproduces that memory footprint for corpora
larger than HBM/RAM:

  HBM:   centroid matrix only (the "memory" tier)
  disk:  packed CSR postings, mmap'd (native C++ reader when built)
  query: device centroid scan -> host stages the probed slabs -> device
         rerank + top-k on the staged batch

Batches are PIPELINED: while the device uploads + reranks batch i, the next
batch's slabs stage on a background native thread (spf_csr_gather_async;
Python thread fallback) — the disk -> host copy hides behind device compute
instead of serializing with it.

The staging buffer is shaped (Q * nprobe, pad, d) per batch — independent of
corpus size — so a DEEP-100M-scale index searches in O(centroids) device
memory (BASELINE.md config 5).
"""

from __future__ import annotations

import contextlib
import functools
import gzip
import json
import os
import threading
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spfresh_tpu.index.config import Config
from spfresh_tpu.index.posting_store import read_packed_postings
from spfresh_tpu.index.spann import (
    CENTROIDS_FILE,
    MANIFEST,
    PACKED_FILE,
    _ids_i32,
    _round_up,
)
from spfresh_tpu.ops.distances import canonical_metric, rowwise_distance
from spfresh_tpu.ops.topk import centroid_topk, smallest_k_unique


class _RwGate:
    """Many-readers / one-writer gate (writer-preferring).

    Searches read; ``reload_base`` (and the compact+reload window in
    :class:`~spfresh_tpu.lire.lazy_fresh.LazySpFreshIndex`) writes.  Without
    it, a search staging batches across a concurrent compact would fetch
    post-compact (empty) overlay patches for pre-compact base slabs —
    transiently resurrecting folded-in tombstones (ADVICE r3)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False

    @contextlib.contextmanager
    def read(self):
        with self._cond:
            while self._writer:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cond:
            while self._writer:
                self._cond.wait()
            self._writer = True  # gate new readers out first, then drain
            while self._readers:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


@functools.partial(jax.jit, static_argnames=("k", "metric", "max_dup"))
def _rerank_staged(queries, staged_vecs, staged_ids, staged_lens,
                   staged_scales, staged_cents, inv, cent_d,
                   k: int, metric: str = "Euclidean", max_dup: int = 8):
    """Rerank host-staged slabs: queries (Q, d); staged_vecs (U, pad, d) are
    the batch's UNIQUE probed slabs (queries in a batch share clusters, so
    the wire carries each slab once); ``inv`` (Q, nprobe) int32 maps each
    probe to its staged row — the fan-out back to (Q, nprobe, pad, d)
    happens on-device as a whole-slab gather."""
    U, pad, d = staged_vecs.shape
    Q, nprobe = inv.shape
    if staged_vecs.dtype == jnp.int8:
        # IVF-SQ8 reconstruction x = centroid + scale * residual code:
        # queries stay f32; the upload already moved 1/4 the f32 bytes.
        qf = queries.astype(jnp.float32)
        slab_vecs = (
            staged_vecs[inv].astype(jnp.float32)
            * staged_scales[inv][..., None, None]
            + staged_cents[inv][:, :, None, :]
        )
    else:
        qf = queries.astype(staged_vecs.dtype)
        slab_vecs = staged_vecs[inv]  # (Q, nprobe, pad, d)
    slab_ids = staged_ids[inv]
    slab_lens = staged_lens[inv]
    dist = rowwise_distance(slab_vecs, qf[:, None, None, :], metric)
    ar = jnp.arange(pad, dtype=jnp.int32)
    valid = (ar < slab_lens[..., None]) & jnp.isfinite(cent_d)[..., None]
    dist = jnp.where(valid, dist, jnp.inf)
    ids = jnp.where(valid, slab_ids, -1)
    n_cand = nprobe * pad
    vals, out_ids = smallest_k_unique(
        dist.reshape(Q, n_cand), ids.reshape(Q, n_cand), k, max_dup=max_dup,
    )
    return jnp.where(jnp.isfinite(vals), out_ids, -1), vals


def _apply_patches(vecs, ids, lens, pids, patches, pad: int, dim: int):
    """Overwrite staged base slabs with the live-update overlay: tombstoned
    entries drop, appended vectors extend the tail, split/merge successor
    postings (no base rows) replace the whole slab.  Host-side, touches only
    the batch's patched rows."""
    if not vecs.flags.writeable:
        vecs = vecs.copy()
    if not ids.flags.writeable:
        ids = ids.copy()
    if not lens.flags.writeable:
        lens = lens.copy()
    for j, pid in enumerate(pids):
        p = patches.get(int(pid))
        if p is None:
            continue
        mode, payload = p
        if mode == "replace":
            nids, nvecs = payload
            n = min(len(nids), pad)
            vecs[j] = 0
            ids[j] = -1
            if n:
                vecs[j, :n] = nvecs[:n]
                ids[j, :n] = nids[:n]
            lens[j] = n
        else:  # "patch": dead-base mask + appended tail
            mask, aids, avecs = payload
            bl = int(lens[j])
            bv, bi = vecs[j, :bl], ids[j, :bl]
            if mask is not None:
                keep = ~mask[:bl]
                bv, bi = bv[keep], bi[keep]
            n = min(len(bi) + len(aids), pad)
            nb = min(len(bi), n)
            na = n - nb
            row_v = np.zeros((pad, vecs.shape[2]), vecs.dtype)
            row_i = np.full(pad, -1, ids.dtype)
            row_v[:nb] = bv[:nb]
            row_i[:nb] = bi[:nb]
            if na:
                row_v[nb : nb + na] = avecs[:na]
                row_i[nb : nb + na] = aids[:na]
            vecs[j] = row_v
            ids[j] = row_i
            lens[j] = n
    return vecs, ids, lens


class _RouteSnap(NamedTuple):
    """One search's immutable view of the routing tier.

    Captured under ``_refresh_lock`` so its fields are mutually consistent;
    every batch of a search reads THIS, never ``self``.  Without it a
    concurrent search's overlay refresh could land between a batch's
    centroid scan and its route-row lookup — rows computed against the old
    matrix indexing a rebuilt (possibly SHORTER) ``_route_pids`` is an
    IndexError at best and a wrong slab-to-centroid pairing at worst."""

    centroids: object       # (Cpad, d) device matrix
    cent_valid: object      # (Cpad,) device mask or None
    route_pids: np.ndarray  # (Cpad,) row -> live pid (-1 = free slot)
    row_base: np.ndarray    # (Cpad,) row -> base CSR row (-1 = overlay-only)
    cent_host: Optional[np.ndarray]  # host mirror (overlay mode) or None
    num_clusters: int
    pad: int
    max_dup: int


class LazySpannIndex:
    """Open a saved packed index without loading posting vectors into memory.

    With ``overlay=`` (a :class:`~spfresh_tpu.lire.packed_storage.
    PackedLireStorage`), the search stays live-update-aware: the device
    centroid matrix refreshes per topology generation (splits/merges grow
    it in place; rows are padded so C-growth rarely recompiles), and staged
    slabs are patched against the overlay's appends/tombstones before
    upload — the disk-backed index serves SPFresh updates without ever
    materializing the corpus."""

    def __init__(self, directory: str, config: Optional[Config] = None, pad: Optional[int] = None,
                 prefetch_threads: Optional[int] = None, overlay=None):
        if prefetch_threads is None:
            # The pipeline only helps when staging can run on a spare core;
            # on a 1-core host every stage (gather, cast, upload) contends
            # for the same CPU and threading measures ~0.85x.
            prefetch_threads = 2 if (os.cpu_count() or 1) > 1 else 0
        self._directory = str(directory)
        with open(os.path.join(directory, MANIFEST)) as f:
            manifest = json.load(f)
        if manifest["layout"] != "packed":
            raise ValueError("lazy mode requires the 'packed' save layout")
        self.config = config or Config.from_dict(manifest.get("config", {}))
        self.metric = canonical_metric(self.config.distance_metric)
        from spfresh_tpu.core.dtypes import DtypePolicy

        self.policy = DtypePolicy(self.config.storage_dtype)
        self.dim = int(manifest["dim"])
        with gzip.open(os.path.join(directory, CENTROIDS_FILE), "rb") as f:
            cent = np.load(f)
        path = os.path.join(directory, PACKED_FILE)
        self._native = None
        try:
            from spfresh_tpu import native

            if native.available():
                self._native = native.NativeCsr(path)
        except Exception:
            self._native = None
        # Python mmap fallback (also used for ids/offsets metadata).
        self._cids, self._offsets, self._ids, self._vectors = read_packed_postings(
            path, mmap=True
        )
        # HBM-resident routing tier (always f32, real units; int8 applies
        # only to the staged slabs, which dequantize per slab at rerank).
        self._centroids = jnp.asarray(cent, jnp.float32)
        # Host mirror: the int8 staging residualizes against these rows.
        self._cent_np = np.asarray(cent, np.float32)
        lens = np.asarray(self._offsets[1:]) - np.asarray(self._offsets[:-1])
        self._lens = lens.astype(np.int32)
        self.num_clusters = len(self._cids)
        self.pad = pad or max(8, _round_up(int(lens.max(initial=1)), 8))
        # Exact replica-multiplicity bound for dedup: from the manifest
        # when the writer recorded it, else a one-time scan on open (the
        # scan costs ~17 s at 100M rows).
        md = manifest.get("max_dup")
        if md is not None:
            self.max_dup = max(1, int(md))
        else:
            from spfresh_tpu.index.spann import _max_multiplicity

            self.max_dup = _max_multiplicity(np.asarray(self._ids))
        # Pipelined staging: background-stage the next batch while the device
        # works on the current one.  prefetch_threads=0 disables the overlap.
        self._pipeline = prefetch_threads > 0
        self._executor = None  # lazy Python-thread fallback when no native lib
        # Live-update overlay (PackedLireStorage): route rows may diverge
        # from base CSR rows once splits/merges land.
        self._overlay = overlay
        self._overlay_gen = None
        self._cent_valid = None
        self._cent_host = None  # host mirror enabling incremental refresh
        self._base_pos = {int(c): i for i, c in enumerate(self._cids)}
        self._route_pids = np.asarray(self._cids, np.int64)
        self._row_base = np.arange(self.num_clusters, dtype=np.int64)
        # Searches read, reload_base (compact swap) writes — see _RwGate.
        self._gate = _RwGate()
        # Serializes routing-tier refreshes AND snapshot capture: the read
        # gate admits many searchers, so two could otherwise interleave
        # inside _refresh_overlay and leave a mixed slot layout behind.
        self._refresh_lock = threading.Lock()
        if overlay is not None:
            self._refresh_overlay()

    def _refresh_overlay(self) -> None:
        """Sync the device routing tier + staging bounds with the overlay.
        Topology changes (split/merge/centroid moves) update the padded
        centroid matrix — INCREMENTALLY when possible (a split touches a
        handful of rows; re-uploading the whole matrix per background op is
        a ~C*d upload + O(C) host loop stall on the serving path, ~51 MB at
        100k x 128 through a slow link), falling back to a full rebuild on
        first sync, growth past the pad, or bulk churn.  Plain appends/
        tombstones only refresh the cheap scalar bounds (pad, dedup hint) —
        the slab patches themselves are fetched per batch."""
        with self._refresh_lock:
            self._refresh_overlay_locked()

    def _routing_snapshot(self) -> _RouteSnap:
        """Capture one mutually-consistent view of the routing tier."""
        with self._refresh_lock:
            return _RouteSnap(
                self._centroids, self._cent_valid, self._route_pids,
                self._row_base, self._cent_host, self.num_clusters,
                self.pad, self.max_dup,
            )

    def _refresh_overlay_locked(self) -> None:
        ov = self._overlay
        gen = ov.topology_gen()
        if gen != self._overlay_gen:
            _, pids, cents = ov.centroid_matrix()
            pids = np.asarray(pids, np.int64)
            cents = np.asarray(cents, np.float32)
            if not self._refresh_routing_incremental(pids, cents):
                C = len(pids)
                Cpad = max(8, _round_up(C, 256))
                centp = np.zeros((Cpad, self.dim), np.float32)
                centp[:C] = cents
                self._centroids = jnp.asarray(centp)
                self._cent_valid = jnp.asarray(np.arange(Cpad) < C)
                self._cent_host = centp
                rp = np.full(Cpad, -1, np.int64)  # padded: a masked row maps
                rp[:C] = pids                     # to pid -1 -> empty patch
                self._route_pids = rp
                rb = np.full(Cpad, -1, np.int64)
                for i, p in enumerate(pids):
                    rb[i] = self._base_pos.get(int(p), -1)
                self._row_base = rb
                self.num_clusters = C
            self._overlay_gen = gen
        need = ov.max_live_len()
        if need > self.pad:
            self.pad = max(8, _round_up(need, 64))
        md = ov.mult_hint()
        if md > self.max_dup:
            self.max_dup = md

    def _refresh_routing_incremental(self, pids, cents) -> bool:
        """Scatter only the changed routing rows into the device matrix.

        Slots are STABLE across refreshes: retired pids free their row, new
        pids take free rows — so a background split touches ~3 rows, not C.
        Returns False (caller rebuilds) on first sync, when new pids exceed
        the free rows, or when churn approaches the rebuild cost anyway."""
        cent_host = getattr(self, "_cent_host", None)
        if cent_host is None or self._cent_valid is None:
            return False
        slot_pids = self._route_pids
        Cpad = len(slot_pids)
        order = np.argsort(slot_pids, kind="stable")
        sp_sorted = slot_pids[order]
        pos = np.minimum(np.searchsorted(sp_sorted, pids), Cpad - 1)
        has = sp_sorted[pos] == pids
        slot_for = order[pos]
        alive = np.zeros(Cpad, bool)
        alive[slot_for[has]] = True
        removed = np.flatnonzero((slot_pids >= 0) & ~alive)
        new_idx = np.flatnonzero(~has)
        free = np.concatenate([removed, np.flatnonzero(slot_pids < 0)])
        if len(new_idx) > len(free):
            return False  # grew past the pad: rebuild with a bigger Cpad
        ex_slots = slot_for[has]
        changed = np.any(cent_host[ex_slots] != cents[has], axis=1)
        upd_slots = ex_slots[changed]
        if (len(upd_slots) + len(new_idx) + len(removed)) * 4 > Cpad:
            return False  # bulk churn: one upload beats many scatters
        assign = free[: len(new_idx)]
        # A freed slot reassigned in the SAME refresh must get the new
        # centroid, not the zeroing write — duplicate scatter indices with
        # different values are undefined.
        zero_slots = np.setdiff1d(removed, assign, assume_unique=True)
        rows = np.concatenate([upd_slots, assign, zero_slots])
        if len(rows) == 0:
            self.num_clusters = len(pids)
            return True
        vals = np.concatenate(
            [
                cents[has][changed],
                cents[new_idx],
                np.zeros((len(zero_slots), self.dim), np.float32),
            ]
        )
        slot_pids = slot_pids.copy()
        slot_pids[removed] = -1
        slot_pids[assign] = pids[new_idx]
        # Copy-on-write: searches hold _RouteSnap references to the OLD
        # mirror; mutating it in place would tear their int8 residual origin.
        cent_host = cent_host.copy()
        cent_host[rows] = vals
        self._cent_host = cent_host
        rb = self._row_base.copy()
        rb[removed] = -1
        rb[assign] = [self._base_pos.get(int(p), -1) for p in pids[new_idx]]
        # Pad the scatter to a small bucket (repeat row 0 with its own
        # value — duplicate .set indices are safe when the values agree) so
        # steady-state refreshes reuse a handful of compiled scatters.
        bucket = max(8, _round_up(len(rows), 8))
        rep_r = np.concatenate([rows, np.repeat(rows[:1], bucket - len(rows))])
        rep_v = np.concatenate(
            [vals, np.repeat(vals[:1], bucket - len(rows), axis=0)]
        )
        self._centroids = self._centroids.at[jnp.asarray(rep_r)].set(
            jnp.asarray(rep_v)
        )
        self._cent_valid = jnp.asarray(slot_pids >= 0)
        self._route_pids = slot_pids
        self._row_base = rb
        self.num_clusters = len(pids)
        return True

    @staticmethod
    @functools.partial(jax.jit, static_argnames=("nprobe", "metric"))
    def _centroid_topk(qb, centroids, cent_valid, nprobe: int, metric: str):
        # Chunked past ~32k centroids (DEEP-scale cluster counts) — the
        # (Q, C) matrix + giant top_k is the wrong shape there.  cent_valid
        # masks the padding rows of an overlay-refreshed matrix (None when
        # no overlay is attached).
        return centroid_topk(qb, centroids, cent_valid, nprobe, metric)

    # -- staging -----------------------------------------------------------

    def _cent_rows_host(self, route_rows: np.ndarray, snap: _RouteSnap) -> np.ndarray:
        """Host centroid rows for the given ROUTE rows — the residual
        origin for int8 staging (must equal what the rerank reconstructs
        with; both sides receive this same array)."""
        if self._overlay is not None and snap.cent_host is not None:
            return snap.cent_host[route_rows, : self.dim]
        return self._cent_np[route_rows]

    def _stage_async(self, rows: np.ndarray, sd_np, patch_info=None,
                     cent_rows=None, pad: Optional[int] = None):
        """Start staging on a background thread; returns an object whose
        .join() -> DEVICE arrays (vecs, ids, lens) in the wire dtype.

        Pipelined: the disk -> host gather runs on the native C++ thread
        (falling back to a Python thread — the ctypes gather releases the
        GIL), and the dtype cast + host -> device upload run on a worker
        thread too, so the whole stage-cast-upload chain for batch i+1
        overlaps batch i's rerank instead of serializing with it.

        ``patch_info`` = (pids, patches) applies the live-update overlay to
        the gathered base slabs before the cast/upload (still on the
        staging thread, so it hides behind device compute too)."""
        if pad is None:
            pad = self.pad

        def to_device(vecs, ids, lens):
            if patch_info is not None:
                vecs, ids, lens = _apply_patches(
                    vecs, ids, lens, patch_info[0], patch_info[1],
                    pad, self.dim,
                )
            if self.policy.quantized:
                from spfresh_tpu.core.dtypes import posting_scales_np, quantize_np

                # IVF-SQ8: residuals vs the ROUTE centroid, per-slab scales
                # from the (overlay-patched) residuals.  Scale + centroid
                # ship WITH the batch, so quantize/dequant are
                # self-consistent by construction.
                res = vecs - cent_rows[:, None, : vecs.shape[2]]
                # Scale from REAL rows only: padding rows are zeros, whose
                # residual is -centroid — letting them into the max would
                # blow the step back up to the coordinate magnitude.
                real = (
                    np.arange(res.shape[1])[None, :, None] < lens[:, None, None]
                )
                rowmax = np.where(real, np.abs(res), 0.0).max(axis=(1, 2))
                scales = posting_scales_np(rowmax)
                vecs = quantize_np(res, scales[:, None, None])
                cents_d = jnp.asarray(cent_rows.astype(np.float32))
            else:
                scales = np.ones(len(vecs), np.float32)
                cents_d = jnp.zeros((len(vecs), 1), jnp.float32)  # unused
                if vecs.dtype != sd_np:  # storage-dtype wire halves bf16 bytes
                    vecs = vecs.astype(sd_np)
            return (jnp.asarray(vecs), jnp.asarray(_ids_i32(ids)),
                    jnp.asarray(lens), jnp.asarray(scales), cents_d)

        if not self._pipeline:
            class _Sync:
                def join(_s, _outer=self, _r=rows, _p=pad):
                    return to_device(*_outer._stage(_r, _p))

            return _Sync()
        # Kick the native gather immediately on its own C++ thread; the
        # worker thread then joins it, casts, and uploads.
        native_job = (
            self._native.gather_padded_async(rows.reshape(-1).astype(np.int32), pad)
            if self._native is not None else None
        )
        from concurrent.futures import ThreadPoolExecutor

        if self._executor is None:
            self._executor = ThreadPoolExecutor(max_workers=1)

        def work():
            staged = native_job.join() if native_job is not None else self._stage(rows, pad)
            return to_device(*staged)

        fut = self._executor.submit(work)

        class _Join:
            def join(self, _fut=fut):
                return _fut.result()

        return _Join()

    def _stage(self, rows: np.ndarray, pad: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host-gather probed postings into a (m, pad, d) slab batch."""
        if pad is None:
            pad = self.pad
        flat = rows.reshape(-1)
        if self._native is not None:
            return self._native.gather_padded(flat.astype(np.int32), pad)
        m = len(flat)
        vecs = np.zeros((m, pad, self.dim), np.float32)
        ids = np.full((m, pad), -1, np.int64)
        lens = np.empty((m,), np.int32)
        offs = np.asarray(self._offsets)
        for i, r in enumerate(flat):
            s, e = int(offs[r]), int(offs[r + 1])
            ln = min(e - s, pad)
            lens[i] = ln
            vecs[i, :ln] = self._vectors[s : s + ln]
            ids[i, :ln] = self._ids[s : s + ln]
        return vecs, ids, lens

    # -- search ------------------------------------------------------------

    def search(self, queries, k: int, nprobe: Optional[int] = None,
               batch_size: int = 64) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[1] != self.dim:
            raise ValueError(f"query dim {queries.shape[1]} != index dim {self.dim}")
        if queries.shape[0] == 0:
            return np.empty((0, k), np.int64), np.empty((0, k), np.float32)
        # Read side of the compact gate: all batches of one search see one
        # consistent (base files, overlay) pair.
        with self._gate.read():
            return self._search_gated(queries, k, nprobe, batch_size)

    def _search_gated(self, queries, k: int, nprobe: Optional[int],
                      batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._overlay is not None:
            self._refresh_overlay()
        # One consistent routing view for ALL batches of this search; a
        # concurrent search's refresh must not swap the tier under us.
        snap = self._routing_snapshot()
        nprobe = max(1, min(int(nprobe or self.config.search.nprobe or k), snap.num_clusters))
        out_i, out_d = [], []

        sd_np = np.dtype(self.policy.storage_dtype)

        def finish(qb, cent_d, inv, job):
            vecs_d, ids_d, lens_d, scales_d, cents_d = job.join()
            qi, qd = _rerank_staged(
                jnp.asarray(qb),
                vecs_d,
                ids_d,
                lens_d,
                scales_d,
                cents_d,
                jnp.asarray(inv),
                cent_d,
                k=int(k),
                metric=self.metric,
                max_dup=snap.max_dup,
            )
            out_i.append(np.asarray(qi))
            out_d.append(np.asarray(qd))

        # Software pipeline: batch i+1 stages (disk -> host, background
        # thread) while batch i uploads + reranks on the device.  Queries in
        # a batch probe overlapping clusters, so only the batch's UNIQUE
        # slabs are staged/uploaded (bucketed so shapes stay compile-stable);
        # the fan-out back to per-probe slabs is an on-device gather.
        pending = None
        for s in range(0, queries.shape[0], batch_size):
            qb = queries[s : s + batch_size]
            cent_d, rows = self._centroid_topk(
                jnp.asarray(qb), snap.centroids, snap.cent_valid,
                nprobe, self.metric,
            )
            rows_np = np.asarray(rows)
            Q = rows_np.shape[0]
            uniq, inv = np.unique(rows_np.reshape(-1), return_inverse=True)
            Upad = max(8, _round_up(len(uniq), 64))
            uniq = np.concatenate([uniq, np.repeat(uniq[:1], Upad - len(uniq))])
            patch_info = None
            stage_rows = uniq
            if self._overlay is not None:
                # Route rows -> base CSR rows (-1 = overlay-only posting:
                # gather row 0, the patch replaces the slab wholesale).
                uniq_pids = snap.route_pids[uniq]
                base = snap.row_base[uniq]
                stage_rows = np.where(base >= 0, base, 0)
                patches = self._overlay.stage_patches(uniq_pids.tolist())
                patch_info = (uniq_pids, patches) if patches else None
            cent_rows = (
                self._cent_rows_host(uniq, snap) if self.policy.quantized else None
            )
            job = self._stage_async(stage_rows, sd_np, patch_info, cent_rows,
                                    pad=snap.pad)
            if pending is not None:
                finish(*pending)
            pending = (qb, cent_d, inv.reshape(Q, nprobe).astype(np.int32), job)
        if pending is not None:
            finish(*pending)
        return np.concatenate(out_i).astype(np.int64), np.concatenate(out_d)

    def reload_base(self):
        """Re-open the packed base files (after an overlay ``compact()``
        swapped them): fresh mmaps, fresh native reader, rebuilt row maps.
        The overlay's topology generation was bumped by the compaction, so
        the next search refreshes the routing tier too.

        Quiesces in-flight searches first.  Callers that must make the
        storage-compact + reload window itself atomic against searches
        (``LazySpFreshIndex.compact``) hold ``self._gate.write()`` across
        both and call :meth:`_reload_base_locked` directly."""
        with self._gate.write():
            self._reload_base_locked()

    def _reload_base_locked(self):
        path = os.path.join(self._directory, PACKED_FILE)
        if self._native is not None:
            try:
                self._native.close()
            except Exception:
                pass
            self._native = None
            try:
                from spfresh_tpu import native

                if native.available():
                    self._native = native.NativeCsr(path)
            except Exception:
                self._native = None
        self._cids, self._offsets, self._ids, self._vectors = read_packed_postings(
            path, mmap=True
        )
        lens = np.asarray(self._offsets[1:]) - np.asarray(self._offsets[:-1])
        self._lens = lens.astype(np.int32)
        self.num_clusters = len(self._cids)
        self.pad = max(self.pad, max(8, _round_up(int(lens.max(initial=1)), 8)))
        from spfresh_tpu.index.spann import _max_multiplicity

        self.max_dup = max(self.max_dup, _max_multiplicity(np.asarray(self._ids)))
        self._base_pos = {int(c): i for i, c in enumerate(self._cids)}
        self._route_pids = np.asarray(self._cids, np.int64)
        self._row_base = np.arange(self.num_clusters, dtype=np.int64)
        # Stale slot state maps to the OLD base rows — force a FULL
        # routing-tier rebuild, not an incremental scatter.
        self._cent_host = None
        self._overlay_gen = None
        if self._overlay is not None:
            self._refresh_overlay()

    def close(self):
        if self._native is not None:
            self._native.close()
            self._native = None
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
