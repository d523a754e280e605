"""Multi-device index build: the subdivision hot loop over a device mesh.

The reference parallelizes its build hot loops with rayon threads
(the reference's src/clustering/hierarchical.rs:144,261,302).  The device
equivalent shards the flat member list of each subdivision level across the
mesh: every device scores its slice of the points against the (replicated)
seed vectors, and the cross-shard reductions — farthest-point seed selection,
membership counts — meet in ``pmax``/``pmin``/``psum`` collectives.

Two corpus layouts:

* ``sharded_split_level`` — corpus REPLICATED per chip, member lists
  sharded.  Shards FLOPs and dispatches; device memory does not scale.
* ``sharded_split_level_rows`` / ``kmeanspp_init_sharded`` — corpus
  ROW-SHARDED (n/S rows per chip).  Every global-row access (seed vectors,
  KMeans++ draws) becomes a psum-contribution gather: the owning shard
  contributes the row, every other shard zeros, and one psum
  replicates the result.  Farthest-point tie-breaks ride the ORIGINAL
  member positions carried as data, so results stay bit-identical to the
  single-device kernel.  This is the layout that makes builds of a corpus
  larger than one device's memory possible.

Semantics of both are IDENTICAL to the single-device
``hierarchical._split_level_multiway`` (same seeds, same assignment, same
tie-breaks), which the tests verify on a virtual 8-device CPU mesh.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spfresh_tpu.ops.distances import rowwise_distance


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis", "metric", "num_segments", "m_ways")
)
def _sharded_split_call(
    X, point_list, cluster_of, valid, c1_idx, seed_valid,
    *, mesh, axis, metric, num_segments, m_ways,
):
    S = num_segments
    M = m_ways
    nshards = mesh.devices.size

    def step(X_rep, pl_local, co_local, valid_local, c1, sv):
        P_local = pl_local.shape[0]
        total = P_local * nshards
        pos0 = jax.lax.axis_index(axis) * P_local
        pos = pos0 + jnp.arange(P_local, dtype=jnp.int32)
        pts = X_rep[pl_local]
        seeds = jnp.zeros((S, M), jnp.int32).at[:, 0].set(c1.astype(jnp.int32))
        d_min = rowwise_distance(pts, X_rep[c1][co_local], metric)
        d1 = d_min
        best_j = jnp.zeros(P_local, jnp.int32)
        taken = pl_local == c1[co_local]

        for j in range(1, M):
            ok = sv[:, j]
            d_masked = jnp.where(
                valid_local & ~taken & ok[co_local], d_min, -jnp.inf
            )
            loc_max = jax.ops.segment_max(d_masked, co_local, num_segments=S)
            glob_max = jax.lax.pmax(loc_max, axis)
            at_max = (
                (d_masked == glob_max[co_local])
                & valid_local & ~taken & ok[co_local]
            )
            loc_pos = jax.ops.segment_min(
                jnp.where(at_max, pos, total), co_local, num_segments=S
            )
            glob_pos = jax.lax.pmin(loc_pos, axis)  # first point at the max
            found = glob_pos < total
            in_shard = (glob_pos >= pos0) & (glob_pos < pos0 + P_local)
            local_idx = jnp.clip(glob_pos - pos0, 0, P_local - 1)
            contrib = jnp.where(
                in_shard & found, pl_local[local_idx].astype(jnp.int32), 0
            )
            seed_j = jax.lax.psum(contrib, axis)  # exactly one shard owns it
            seed_j = jnp.where(found, seed_j, seeds[:, 0])
            seeds = seeds.at[:, j].set(seed_j)
            use = ok & found
            d_new = rowwise_distance(pts, X_rep[seed_j][co_local], metric)
            upd = use[co_local] & (d_new < d_min)
            best_j = jnp.where(upd, j, best_j)
            d_min = jnp.where(upd, d_new, d_min)
            taken = taken | ((pos == glob_pos[co_local]) & use[co_local])

        counts = jax.lax.psum(
            jax.ops.segment_sum(
                valid_local.astype(jnp.int32),
                co_local * M + best_j,
                num_segments=S * M,
            ),
            axis,
        ).reshape(S, M)
        return best_j, seeds, counts, d1

    return jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P(), P(), P(axis)),
        check_vma=False,
    )(X, point_list, cluster_of, valid, c1_idx, seed_valid)


def sharded_split_level(
    mesh: Mesh,
    X_rep: jax.Array,
    point_list: np.ndarray,
    cluster_of: np.ndarray,
    valid: np.ndarray,
    c1_idx: np.ndarray,
    seed_valid: np.ndarray,
    metric: str,
    num_segments: int,
    m_ways: int,
    axis: Optional[str] = None,
):
    """Mesh-sharded drop-in for ``_split_level_multiway``: shards the padded
    member arrays over the mesh (host staging only — never the default
    backend) and returns the same (assign, seeds, counts, d1)."""
    axis = axis or mesh.axis_names[0]
    shard = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    point_list = np.asarray(point_list, np.int32)
    cluster_of = np.asarray(cluster_of, np.int32)
    valid = np.asarray(valid, bool)
    n = point_list.shape[0]
    # Pad the member axis to a mesh multiple (callers pad to pow2, which a
    # non-pow2 mesh does not divide).  Padding rows carry valid=False, so
    # they join no segment sum and win no seed; outputs slice back to n.
    S = mesh.devices.size
    n_pad = ((n + S - 1) // S) * S
    if n_pad != n:
        point_list = np.concatenate([point_list, np.repeat(point_list[:1], n_pad - n)])
        cluster_of = np.concatenate([cluster_of, np.repeat(cluster_of[:1], n_pad - n)])
        valid = np.concatenate([valid, np.zeros(n_pad - n, bool)])
    assign, seeds, counts, d1 = _sharded_split_call(
        X_rep,
        jax.device_put(point_list, shard),
        jax.device_put(cluster_of, shard),
        jax.device_put(valid, shard),
        jax.device_put(np.asarray(c1_idx, np.int32), rep),
        jax.device_put(np.asarray(seed_valid, bool), rep),
        mesh=mesh,
        axis=axis,
        metric=metric,
        num_segments=num_segments,
        m_ways=m_ways,
    )
    if n_pad != n:
        assign, d1 = assign[:n], d1[:n]
    return assign, seeds, counts, d1


# ---------------------------------------------------------------------------
# Row-sharded corpus layout: n/S rows per chip, psum-contribution gathers
# ---------------------------------------------------------------------------


def _fpoint_loop(
    x_loc, pts, gpid, co_l, valid_l, opos_l, c1, sv,
    *, axis, metric, S_seg, M, pbig,
):
    """Farthest-point M-way split loop over row-sharded members — the one
    body shared by the upload kernel (`_rowsharded_split_call`) and the
    resident kernel (`_resident_split_call`), op-for-op, so both stay
    bit-identical to the single-device `_split_level_core`.

    ``opos_l`` is the tie-break key: any per-entry value whose WITHIN-
    segment ordering equals the single-device member order (position in the
    concatenated ascending member lists, or equivalently the global row id
    — member lists are always ascending); ``pbig`` is its padding sentinel
    (strictly greater than every real key)."""
    rps = x_loc.shape[0]
    row0 = jax.lax.axis_index(axis) * rps

    def gather_rows(rows):
        """(m,) global row ids -> (m, d) replicated, via psum
        contribution from the owning shard (zeros elsewhere)."""
        in_sh = (rows >= row0) & (rows < row0 + rps)
        li = jnp.clip(rows - row0, 0, rps - 1)
        return jax.lax.psum(
            jnp.where(in_sh[:, None], x_loc[li], 0.0), axis
        )

    c1v = gather_rows(c1)  # (S_seg, d) seed-0 vectors
    d_min = rowwise_distance(pts, c1v[co_l], metric)
    d1 = d_min
    best_j = jnp.zeros_like(gpid)
    taken = gpid == c1[co_l]
    seeds = jnp.zeros((S_seg, M), jnp.int32).at[:, 0].set(
        c1.astype(jnp.int32)
    )
    for j in range(1, M):
        ok = sv[:, j]
        d_masked = jnp.where(
            valid_l & ~taken & ok[co_l], d_min, -jnp.inf
        )
        gmax = jax.lax.pmax(
            jax.ops.segment_max(d_masked, co_l, num_segments=S_seg), axis
        )
        at_max = (
            (d_masked == gmax[co_l]) & valid_l & ~taken & ok[co_l]
        )
        # First (by ORIGINAL position) point at the max — the exact
        # single-device tie-break, carried as data so the per-shard
        # repartition cannot change it.
        gpos = jax.lax.pmin(
            jax.ops.segment_min(
                jnp.where(at_max, opos_l, pbig), co_l,
                num_segments=S_seg,
            ),
            axis,
        )
        found = gpos < pbig
        mine = at_max & (opos_l == gpos[co_l])  # unique winner entry
        seed_j = jax.lax.psum(
            jax.ops.segment_sum(
                jnp.where(mine, gpid, 0), co_l, num_segments=S_seg
            ),
            axis,
        )
        seed_j = jnp.where(found, seed_j, c1.astype(jnp.int32))
        seeds = seeds.at[:, j].set(seed_j)
        sv_vec = jax.lax.psum(
            jax.ops.segment_sum(
                jnp.where(mine[:, None], pts, 0.0), co_l,
                num_segments=S_seg,
            ),
            axis,
        )  # (S_seg, d) winner vectors (zeros where not found; masked)
        use = ok & found
        d_new = rowwise_distance(pts, sv_vec[co_l], metric)
        upd = use[co_l] & (d_new < d_min)
        best_j = jnp.where(upd, j, best_j)
        d_min = jnp.where(upd, d_new, d_min)
        taken = taken | ((opos_l == gpos[co_l]) & use[co_l])
    counts = jax.lax.psum(
        jax.ops.segment_sum(
            valid_l.astype(jnp.int32), co_l * M + best_j,
            num_segments=S_seg * M,
        ),
        axis,
    ).reshape(S_seg, M)
    return best_j, seeds, counts, d1


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis", "metric", "num_segments", "m_ways", "pbig"),
)
def _rowsharded_split_call(
    X, pid_loc, co, valid, opos, c1_idx, seed_valid,
    *, mesh, axis, metric, num_segments, m_ways, pbig,
):
    S_seg = num_segments
    M = m_ways

    def step(x_loc, pid, co_l, valid_l, opos_l, c1, sv):
        rps = x_loc.shape[0]
        row0 = jax.lax.axis_index(axis) * rps
        pts = x_loc[pid]  # (L, d) — members this shard OWNS (local gather)
        gpid = (row0 + pid).astype(jnp.int32)  # global point ids
        return _fpoint_loop(
            x_loc, pts, gpid, co_l, valid_l, opos_l, c1, sv,
            axis=axis, metric=metric, S_seg=S_seg, M=M, pbig=pbig,
        )

    return jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P(), P(), P(axis)),
        check_vma=False,
    )(X, pid_loc, co, valid, opos, c1_idx, seed_valid)


def sharded_split_level_rows(
    mesh: Mesh,
    X_shard: jax.Array,  # (n_pad, d) ROW-SHARDED over the mesh
    flat_members: np.ndarray,  # (P,) global point ids (no padding)
    cluster_of: np.ndarray,  # (P,)
    c1_idx: np.ndarray,  # (num_segments,) seed-0 global row per segment
    seed_valid: np.ndarray,  # (num_segments, m_ways)
    metric: str,
    num_segments: int,
    m_ways: int,
    axis: Optional[str] = None,
):
    """Row-sharded-corpus drop-in for ``_split_level_multiway``.

    The host deals each member entry to the shard OWNING its corpus row
    (owner = id // rows_per_shard), padding every shard's list to a common
    length; original positions ride along so seed tie-breaks are exactly
    the single-device ones.  Returns (assign (P,), seeds, counts, d1 (P,))
    as numpy, already un-permuted to the caller's member order."""
    axis = axis or mesh.axis_names[0]
    S = mesh.devices.size
    rps = X_shard.shape[0] // S
    P_n = int(flat_members.shape[0])
    flat_members = np.asarray(flat_members, np.int64)
    cluster_of = np.asarray(cluster_of, np.int32)
    owner = (flat_members // rps).astype(np.int64)
    order = np.argsort(owner, kind="stable")
    cnt = np.bincount(owner, minlength=S)
    L = max(8, int(-(-int(cnt.max()) // 8) * 8))
    pid_loc = np.zeros((S, L), np.int32)
    co = np.zeros((S, L), np.int32)
    valid = np.zeros((S, L), bool)
    opos = np.full((S, L), P_n, np.int32)  # pbig sentinel for padding
    offs = np.zeros(S + 1, np.int64)
    np.cumsum(cnt, out=offs[1:])
    fm_o = flat_members[order]
    co_o = cluster_of[order]
    for s in range(S):
        m = int(cnt[s])
        pid_loc[s, :m] = (fm_o[offs[s] : offs[s] + m] - s * rps).astype(np.int32)
        co[s, :m] = co_o[offs[s] : offs[s] + m]
        valid[s, :m] = True
        opos[s, :m] = order[offs[s] : offs[s] + m].astype(np.int32)
    shard = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    assign, seeds, counts, d1 = _rowsharded_split_call(
        X_shard,
        jax.device_put(pid_loc.reshape(-1), shard),
        jax.device_put(co.reshape(-1), shard),
        jax.device_put(valid.reshape(-1), shard),
        jax.device_put(opos.reshape(-1), shard),
        jax.device_put(np.asarray(c1_idx, np.int32), rep),
        jax.device_put(np.asarray(seed_valid, bool), rep),
        mesh=mesh,
        axis=axis,
        metric=metric,
        num_segments=num_segments,
        m_ways=m_ways,
        pbig=P_n,
    )
    from spfresh_tpu.utils.xfer import timed_pull

    assign = timed_pull(assign)
    seeds = timed_pull(seeds)
    counts = timed_pull(counts)
    d1 = timed_pull(d1)
    opos_flat = opos.reshape(-1)
    valid_flat = valid.reshape(-1)
    assign_out = np.zeros(P_n, np.int32)
    d1_out = np.zeros(P_n, np.float32)
    assign_out[opos_flat[valid_flat]] = assign[valid_flat]
    d1_out[opos_flat[valid_flat]] = d1[valid_flat]
    return assign_out, seeds, counts, d1_out


# ---------------------------------------------------------------------------
# Device-resident subdivision over the row-sharded mesh (round-4 lever 5):
# the persistent per-point cluster-id vector lives SHARDED on the mesh across
# levels; each level's wire traffic is the KB-scale seg_map/offs/seed_valid
# inputs and the (S, M) seeds/counts outputs — no more per-level member-table
# uploads (the mesh analogue of hierarchical._subdivide_multiway_resident).
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis", "metric", "num_segments", "m_ways", "n"),
)
def _resident_split_call(
    X, gci, seg_map, offs, seed_valid,
    *, mesh, axis, metric, num_segments, m_ways, n,
):
    S_seg = num_segments
    M = m_ways
    nsh = mesh.devices.size

    def step(x_loc, gci_loc, smap, off, sv):
        rps = x_loc.shape[0]
        myi = jax.lax.axis_index(axis)
        row0 = (myi * rps).astype(jnp.int32)
        lidx = jnp.arange(rps, dtype=jnp.int32)
        grow = row0 + lidx  # global row ids of this shard's slice
        seg = smap[gci_loc.astype(jnp.int32)]  # (rps,) -1 = not oversized
        # Mesh-padding corpus rows (grow >= n) belong to no segment.
        validp = (seg >= 0) & (grow < n)
        segk = jnp.where(validp, seg, S_seg).astype(jnp.int32)
        # Local lexicographic (segment, row) sort front-packs this shard's
        # members in ascending-global-row order per segment — the same
        # within-segment order as the host's concatenated member lists.
        sort_seg, pid = jax.lax.sort((segk, lidx), num_keys=2)
        valid_l = sort_seg < S_seg
        co_l = jnp.where(valid_l, sort_seg, 0).astype(jnp.int32)
        pid = jnp.where(valid_l, pid, 0)
        pts = x_loc[pid]
        gpid = (row0 + pid).astype(jnp.int32)
        # Tie-break key: the global row id — within a segment its ordering
        # equals the flat-member position the single-device kernels use.
        opos_l = jnp.where(valid_l, gpid, jnp.int32(n))
        # Seed-0 = the off[r]-th member of segment r in ascending global-row
        # order (the host path's flat_members[bounds[:-1] + offs]): local
        # per-segment counts meet in an all_gather, the shard holding global
        # rank off[r] contributes the row id, one psum replicates it.
        loc_cnt = jax.ops.segment_sum(
            valid_l.astype(jnp.int32), co_l, num_segments=S_seg
        )
        all_cnt = jax.lax.all_gather(loc_cnt, axis)  # (nsh, S_seg)
        before = jnp.arange(nsh, dtype=jnp.int32)[:, None] < myi
        prefix = jnp.sum(jnp.where(before, all_cnt, 0), axis=0)
        tgt = off.astype(jnp.int32) - prefix
        seg_start = jnp.cumsum(loc_cnt) - loc_cnt  # exclusive, sorted order
        has = (tgt >= 0) & (tgt < loc_cnt)
        ppos = jnp.clip(seg_start + tgt, 0, rps - 1)
        c1 = jax.lax.psum(jnp.where(has, gpid[ppos], 0), axis)  # (S_seg,)
        best_j, seeds, counts, d1 = _fpoint_loop(
            x_loc, pts, gpid, co_l, valid_l, opos_l, c1, sv,
            axis=axis, metric=metric, S_seg=S_seg, M=M, pbig=n,
        )
        # Back to local-ROW order so the persistent-gci apply needs no
        # member tables (int8 assign: m_ways <= 127 structurally).
        tgt_rows = jnp.where(valid_l, pid, rps)
        assign_row = jnp.zeros(rps, jnp.int8).at[tgt_rows].set(
            best_j.astype(jnp.int8), mode="drop"
        )
        d1_row = jnp.zeros(rps, d1.dtype).at[tgt_rows].set(d1, mode="drop")
        return assign_row, seeds, counts, d1_row

    return jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P()),
        out_specs=(P(axis), P(), P(), P(axis)),
        check_vma=False,
    )(X, gci, seg_map, offs, seed_valid)


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis", "m_ways", "n"),
    donate_argnums=(0,),
)
def _resident_apply_call(
    gci, seg_map, assign_row, child_map, *, mesh, axis, m_ways, n
):
    """Sharded level-assign apply: ``gci[i] = child_map[seg_i * m_ways +
    assign_i]`` for this level's member rows; everything else unchanged."""

    def step(gci_loc, smap, asg, cmap):
        rps = gci_loc.shape[0]
        row0 = jax.lax.axis_index(axis) * rps
        grow = row0 + jnp.arange(rps, dtype=jnp.int32)
        seg = smap[gci_loc.astype(jnp.int32)]
        member = (seg >= 0) & (grow < n)
        # maximum() only neutralizes the -1 non-member sentinel (those rows
        # are masked by `member` below); the cmap read is guarded by the
        # slot clip on the next line.
        slot = jnp.maximum(seg, 0) * m_ways + asg.astype(jnp.int32)
        newid = cmap[jnp.clip(slot, 0, cmap.shape[0] - 1)]
        return jnp.where(member, newid, gci_loc)

    return jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis), P(), P(axis), P()),
        out_specs=P(axis),
        check_vma=False,
    )(gci, seg_map, assign_row, child_map)


def kmeanspp_init_sharded(
    mesh: Mesh,
    key,
    X_shard: jax.Array,  # (n_pad, d) ROW-SHARDED
    k: int,
    metric: str,
    n: int,
    axis: Optional[str] = None,
):
    """KMeans++ seeding over a row-sharded corpus — bit-identical to the
    single-device ``_kmeanspp_init`` (hierarchical.py): per-row distances
    are computed locally, the (n,) weight vector is all_gathered (4 MB at
    1M — the corpus rows are what must not replicate, not the scalars), and
    the categorical draw runs replicated on the identical (n,) logits with
    the identical folded key."""
    axis = axis or mesh.axis_names[0]

    @functools.partial(
        jax.jit, static_argnames=("mesh_", "axis_", "k_", "metric_", "n_")
    )
    def run(X, key_, *, mesh_, axis_, k_, metric_, n_):
        def step(x_loc, kk):
            rps = x_loc.shape[0]
            row0 = jax.lax.axis_index(axis_) * rps

            def gather1(row):
                in_sh = (row >= row0) & (row < row0 + rps)
                li = jnp.clip(row - row0, 0, rps - 1)
                return jax.lax.psum(
                    jnp.where(in_sh, x_loc[li], 0.0), axis_
                )

            first = jax.random.randint(
                jax.random.fold_in(kk, 0), (), 0, n_
            )
            fv = gather1(first)
            min_d = rowwise_distance(x_loc, fv[None, :], metric_)
            chosen = jnp.zeros((k_,), jnp.int32).at[0].set(
                first.astype(jnp.int32)
            )

            def body(i, state):
                md, ch = state
                full = jax.lax.all_gather(md, axis_).reshape(-1)[:n_]
                w = full * full
                total = jnp.sum(w)
                w = jnp.where(total > 0, w, jnp.ones_like(w))
                idx = jax.random.categorical(
                    jax.random.fold_in(kk, i), jnp.log(w)
                )
                dv = gather1(idx)
                d_new = rowwise_distance(x_loc, dv[None, :], metric_)
                return jnp.minimum(md, d_new), ch.at[i].set(
                    idx.astype(jnp.int32)
                )

            _, chosen = jax.lax.fori_loop(1, k_, body, (min_d, chosen))
            return chosen

        return jax.shard_map(
            step, mesh=mesh_, in_specs=(P(axis), P()), out_specs=P(),
            check_vma=False,
        )(X, key_)

    return run(
        X_shard, key, mesh_=mesh, axis_=axis, k_=int(k), metric_=metric,
        n_=int(n),
    )
