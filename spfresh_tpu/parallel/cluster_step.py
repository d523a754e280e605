"""Data-parallel clustering step over a device mesh.

The "training step" of an ANN engine is the index-build iteration: assign
every point to its nearest centroid (+ boundary closure) and refresh medoid
centroids.  Sharded over the mesh's data axis: each device scores its slice
of the corpus against replicated centroids; the segment-sums behind the
means and the global medoid argmins meet in ``psum`` / ``argmin-of-pmin``
collectives.  This is the multi-chip path exercised by
``__graft_entry__.dryrun_multichip`` and used for very large builds.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spfresh_tpu.core.dtypes import ACCUM_DTYPE
from spfresh_tpu.ops.distances import pairwise_distance


def sharded_cluster_step(
    mesh: Mesh,
    X: jax.Array,
    cent_vecs: jax.Array,
    boundary_threshold: float = 1.1,
    metric: str = "Euclidean",
    axis: Optional[str] = None,
    closure: bool = True,
    return_rows: bool = False,
):
    """One assign + medoid-update round, data-sharded.

    X (n, d) sharded on rows over ``axis``; cent_vecs (k, d) replicated.
    Returns (member_mask (n, k) sharded like X, new_cent_vecs (k, d)
    replicated[, medoid_rows (k,) int32 replicated when ``return_rows``]).
    ``closure=False`` gives hard nearest-centroid assignment (the 'final'
    replication mode of the build; closure replicas are added once at the
    end).  The medoid uses a global-argmin trick: each shard proposes its
    best (distance, global_row) pair per cluster and the collective picks
    the worldwide winner with an exact integer tie-break.
    """
    axis = axis or mesh.axis_names[0]
    nshards = mesh.devices.size
    n = X.shape[0]
    if n % nshards != 0:
        raise ValueError(f"n={n} must divide evenly over {nshards} shards (pad first)")

    # numpy scalar: a jnp scalar here would be committed to the *default*
    # backend at call time — this function must never touch it (the mesh may
    # be a CPU mesh while the default backend is another platform).
    bt = np.float32(boundary_threshold)

    def step(x_local, cents):
        shard_id = jax.lax.axis_index(axis)
        local_n = x_local.shape[0]
        row0 = shard_id * local_n

        # Assignment (local compute, no comms); closure replicas optional.
        D = pairwise_distance(x_local, cents, metric)  # (n_local, k)
        best = jnp.argmin(D, axis=1)
        min_d = jnp.min(D, axis=1)
        onehot = jax.nn.one_hot(best, D.shape[1], dtype=bool)
        if closure:
            cc = pairwise_distance(cents, cents, metric)
            mask = onehot | ((D < (bt * min_d)[:, None]) & (cc[best] >= D))
        else:
            mask = onehot

        # Means: local segment sums -> psum over the mesh.
        m = mask.astype(ACCUM_DTYPE)
        sums = jax.lax.psum(
            jax.lax.dot_general(
                m, x_local,
                dimension_numbers=(((0,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=ACCUM_DTYPE,
            ),
            axis,
        )  # (k, d)
        counts = jax.lax.psum(jnp.sum(m, axis=0), axis)  # (k,)
        means = sums / jnp.maximum(counts, 1.0)[:, None]

        # Medoid: best member per cluster, globally.  Pack (dist, global_row)
        # so pmin on dist carries the argmin along.
        Dm = pairwise_distance(x_local, means, metric)  # (n_local, k)
        Dm = jnp.where(mask, Dm, jnp.inf)
        local_best_row = jnp.argmin(Dm, axis=0)  # (k,)
        local_best_d = jnp.min(Dm, axis=0)
        global_rows = (row0 + local_best_row).astype(jnp.int32)

        # Lexicographic global argmin: gather distances and int32 row ids as
        # SEPARATE arrays (packing rows into f32 loses integer precision past
        # 2^24 rows), take the min distance, then the smallest row id among
        # the shards achieving it — an exact integer tie-break.
        dists_all = jax.lax.all_gather(local_best_d, axis)  # (S, k) f32
        rows_all = jax.lax.all_gather(global_rows, axis)  # (S, k) int32
        min_d = jnp.min(dists_all, axis=0)  # (k,)
        at_min = dists_all == min_d[None, :]
        best_rows = jnp.min(
            jnp.where(at_min, rows_all, jnp.iinfo(jnp.int32).max), axis=0
        )  # (k,) int32

        # Gather the winning vectors: every shard contributes its rows (zeros
        # elsewhere) and a psum assembles the replicated centroid matrix.
        in_shard = (best_rows >= row0) & (best_rows < row0 + local_n)
        local_idx = jnp.clip(best_rows - row0, 0, local_n - 1)
        contrib = jnp.where(in_shard[:, None], x_local[local_idx], 0.0)
        new_cents = jax.lax.psum(contrib, axis)  # (k, d)
        # Empty clusters keep their previous centroid.
        empty = counts <= 0
        new_cents = jnp.where(empty[:, None], cents, new_cents)
        rows_out = jnp.where(empty, -1, best_rows)
        return mask, new_cents, rows_out

    fn = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=(P(axis), P(), P()),
        check_vma=False,
    )
    mask, new_cents, rows = fn(X, cent_vecs)
    if return_rows:
        return mask, new_cents, rows
    return mask, new_cents


def sharded_replica_pass(
    mesh: Mesh,
    X: jax.Array,
    base: jax.Array,
    cent_vecs: jax.Array,
    metric: str = "Euclidean",
    boundary_threshold: float = 1.1,
    n_extra: int = 7,
    axis: Optional[str] = None,
    soar_lambda: float = 0.0,
):
    """Final closure-replication pass, data-sharded over the mesh.

    Pure data parallelism — each chip scores its row slice of the corpus
    against the replicated centroid set with the same closure rule as the
    single-device ``_final_replica_pass``; no collectives are needed.  This
    is the build's third hot loop (the reference parallelizes it with rayon,
    hierarchical.rs:302) and the last single-device phase of the mesh build.

    X (n, d) sharded on rows over ``axis``; base (n,) int32 sharded alike;
    cent_vecs (C, d) replicated.  Returns (idx (n, n_extra) int32,
    dists (n, n_extra) f32), both sharded like X.
    """
    from spfresh_tpu.clustering.hierarchical import _final_replica_pass

    axis = axis or mesh.axis_names[0]
    nshards = mesh.devices.size
    if X.shape[0] % nshards != 0:
        raise ValueError(
            f"n={X.shape[0]} must divide evenly over {nshards} shards (pad first)"
        )
    bt = np.float32(boundary_threshold)

    def step(x_local, base_local, cents):
        return _final_replica_pass(
            x_local, base_local, cents, metric, bt, n_extra,
            soar_lambda=soar_lambda,
        )

    return jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    )(X, base, cent_vecs)


def _host_array(x):
    """Host staging that never touches the default jax backend.

    ``jnp.asarray`` commits host data to the *default* device before any
    re-placement — a wasted transfer, and the wrong device when the mesh is
    not on the default backend.  Committed jax arrays pass through
    untouched; everything else stages via numpy.
    """
    if isinstance(x, jax.Array):
        return x
    return np.asarray(x)


def replicate(mesh: Mesh, x) -> jax.Array:
    return jax.device_put(_host_array(x), NamedSharding(mesh, P()))


def shard_rows(mesh: Mesh, x, axis: Optional[str] = None) -> jax.Array:
    axis = axis or mesh.axis_names[0]
    return jax.device_put(_host_array(x), NamedSharding(mesh, P(axis)))
