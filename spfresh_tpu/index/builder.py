"""Build/load façade (parity: /root/reference/src/spann/spann_builder.rs).

``build`` runs clustering -> posting lists -> centroid index -> save, with the
reference's balance cap default ``desired_cluster_size = round(0.18 * n)``
(spann_builder.rs:48-49) unless the config overrides it (the reference never
lets you — SURVEY.md section 5 "config").

``mesh``: the build's hot loops — assign + medoid, multi-way
subdivision, the replica pass — run data-sharded over a
``jax.sharding.Mesh`` with psum/pmax/pmin collectives, the device
analogue of the reference's rayon pools (hierarchical.rs:144,261,302).
``mesh="auto"`` uses all local devices when more than one REAL accelerator
is attached (virtual CPU meshes must be passed explicitly — tests do).
Results are bit-identical to the single-device path.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from spfresh_tpu.clustering.hierarchical import HierarchicalClustering
from spfresh_tpu.index.config import Config
from spfresh_tpu.index.spann import SpannIndex

log = logging.getLogger(__name__)


def _resolve_mesh(mesh):
    """None | "auto" | int (device count) | Mesh -> Optional[Mesh]."""
    if mesh is None:
        return None
    import jax
    from jax.sharding import Mesh

    if isinstance(mesh, Mesh):
        return mesh if mesh.devices.size > 1 else None
    if mesh == "auto":
        devices = jax.devices()
        if len(devices) > 1 and devices[0].platform != "cpu":
            return Mesh(np.array(devices), ("shard",))
        return None
    if isinstance(mesh, int):
        devices = jax.devices()
        if mesh > len(devices):
            raise ValueError(f"mesh={mesh} devices requested, {len(devices)} available")
        return Mesh(np.array(devices[:mesh]), ("shard",)) if mesh > 1 else None
    raise TypeError(f"mesh must be None, 'auto', an int, or a Mesh; got {mesh!r}")


class SpannIndexBuilder:
    """Mirror of SpannIndexBuilder (spann_builder.rs:8-75) + mesh scale-out."""

    def __init__(self, config: Config | str, mesh=None, corpus_layout: str = "sharded"):
        """``corpus_layout`` (mesh builds only): "sharded" keeps n/S corpus
        rows per chip — the layout that scales HBM and builds corpora larger
        than one chip; "replicated" keeps a full per-chip copy (and hands
        the device corpus to the zero-upload view pack)."""
        self.config = Config.from_file(config) if isinstance(config, str) else config
        self.config.validate()
        self.data: Optional[np.ndarray] = None
        self.mesh = _resolve_mesh(mesh)
        self.corpus_layout = corpus_layout

    def with_data(self, data) -> "SpannIndexBuilder":
        self.data = np.asarray(data, dtype=np.float32)
        if self.data.ndim != 2:
            raise ValueError(f"data must be 2-d, got shape {self.data.shape}")
        return self

    def build(self, dim: Optional[int] = None, save: bool = True) -> SpannIndex:
        """build::<N> (spann_builder.rs:25-64).  ``dim`` is an optional check
        standing in for the reference's const-generic N (dim check at
        spann_builder.rs:38-45)."""
        if self.data is None:
            raise ValueError("no data provided; call with_data() first")
        n, d = self.data.shape
        if dim is not None and dim != d:
            raise ValueError(f"data dimension {d} does not match requested dim {dim}")

        params = self.config.to_clustering_params()
        if params.desired_cluster_size is None:
            params.desired_cluster_size = max(1, int(round(0.18 * n)))
        if self.config.build_sample_rows is not None:
            return self._build_outofcore(params, save)
        log.info(
            "building SPANN index: n=%d d=%d k=%d cap=%d metric=%s mesh=%s",
            n, d, params.initial_k, params.desired_cluster_size, params.metric,
            self.mesh.devices.size if self.mesh is not None else 1,
        )
        hc = HierarchicalClustering(
            params, self.data, mesh=self.mesh, corpus_layout=self.corpus_layout
        ).fit()

        index = SpannIndex(self.config)
        # Per-phase build walls (always measured; see PhaseTimer in fit) —
        # the bench reads these into its JSON side-channel so the official
        # artifact shows where every build second went.
        index.build_profile = {
            name: round(total, 3) for name, total, _ in hc._timer.totals()
        }
        # Hand the clustering phase's device-resident corpus to the index:
        # the first search view then packs entirely on-chip (no multi-GB
        # member-vector re-upload from the host).  On a REPLICATED mesh any
        # one addressable shard holds the full copy as a plain single-device
        # array the (single-chip) view pack can gather from; a row-SHARDED
        # corpus has no full copy anywhere — the view pack stages from host
        # (at that scale the search index is Lazy/Sharded anyway).
        corpus_dev = hc.data
        if self.mesh is not None:
            corpus_dev = None
            if hc._corpus_layout == "replicated":
                try:
                    corpus_dev = hc.data.addressable_shards[0].data
                except (AttributeError, IndexError):
                    corpus_dev = None
        # Host member source.  int8 storage needs the clusterer's MIRROR,
        # which carries the same wire rounding as the device corpus — host-
        # and device-packed views must quantize identical coordinates.
        # Float storage keeps the EXACT caller corpus: the saved f32 disk
        # bytes must not silently degrade to bf16-rounded values (bf16
        # serving re-rounds idempotently either way, so device/host view
        # consistency holds from the exact source too).
        host_src = (
            hc._host_data
            if (self.config.storage_dtype == "int8"
                and hc._host_data is not None)
            else self.data
        )
        index.create_posting_lists(hc.clusters, host_src, corpus_dev=corpus_dev)
        # The device view (centroid index, build_kdtree parity) materializes
        # lazily on first search, in the layout the search engine needs —
        # eagerly building both CSR and slab views would double the upload.
        if save:
            index.save(self.config.output_path)
        return index

    def _build_outofcore(self, params, save: bool) -> SpannIndex:
        """Out-of-core build: host-resident corpus, streamed device tiles
        (clustering/outofcore.py).  With a mesh, the streamed assign and
        replica passes round-robin their tiles across the mesh's devices —
        pure data parallelism over rows (no collectives; the in-core mesh
        build's shard_map path needs a device-resident corpus, exactly what
        out-of-core exists to avoid).  Results are identical for any device
        count.  This is the DEEP-100M shape: corpus > total HBM, built on
        however many chips are attached."""
        from spfresh_tpu.clustering.outofcore import (
            DEFAULT_TILE_ROWS,
            fit_outofcore,
        )
        from spfresh_tpu.utils import PhaseTimer

        devices = (
            list(self.mesh.devices.flatten()) if self.mesh is not None else None
        )
        n, d = self.data.shape
        log.info(
            "building SPANN index OUT-OF-CORE: n=%d d=%d sample=%d tile=%d devices=%d",
            n, d, self.config.build_sample_rows,
            self.config.build_tile_rows or DEFAULT_TILE_ROWS,
            len(devices) if devices else 1,
        )
        timer = PhaseTimer()
        result = fit_outofcore(
            params,
            self.data,
            self.config.build_sample_rows,
            tile_rows=self.config.build_tile_rows or DEFAULT_TILE_ROWS,
            timer=timer,
            devices=devices,
        )
        index = SpannIndex(self.config)
        index.build_profile = {
            name: round(total, 3) for name, total, _ in timer.totals()
        }
        # Host-lazy postings: member vectors materialize from the host
        # corpus only when a save/update touches them — the index never
        # holds a stored-x copy of a corpus that may not fit in RAM twice.
        index.create_posting_lists(
            result.clusters, self.data, corpus_dev=None, lazy_host=True
        )
        if save:
            index.save(self.config.output_path)
        return index

    def load(self, dim: Optional[int] = None) -> SpannIndex:
        """load::<N> (spann_builder.rs:66-75)."""
        index = SpannIndex.load(self.config.output_path, self.config)
        if dim is not None and index.dim != dim:
            raise ValueError(f"loaded index dim {index.dim} does not match requested dim {dim}")
        return index
