"""YAML/JSON config system (parity: the reference's src/spann/config.rs).

Same schema and validation whitelist as the reference (config.rs:59-87), plus
the knobs the reference computes internally or hardcodes (SURVEY.md section 5
"config"): ``desired_cluster_size`` / ``rng_seed`` (builder hardcodes
0.18*n / None at spann_builder.rs:48-49, config.rs:110-111) and a ``search``
section exposing ``nprobe`` independently of ``k`` (the reference conflates
them, spann_index.rs:164) and the optional 1.2x dynamic pruning factor
(spann_index.rs:165).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

from spfresh_tpu.clustering.hierarchical import ClusteringParams, canonical_init
from spfresh_tpu.ops.distances import canonical_metric


@dataclasses.dataclass
class SearchConfig:
    nprobe: Optional[int] = None  # None -> nprobe = k (reference behavior)
    prune_factor: Optional[float] = None  # e.g. 1.2 for reference-style pruning
    query_batch_size: int = 4096
    # Spare member slots per posting slab: lets live inserts scatter into the
    # device view in place instead of forcing a full repack the moment the
    # largest posting grows by one.
    slab_growth_slots: int = 16
    # "bfloat16" ships query batches to the device in bf16 (upcast to f32
    # on device before any kernel math), halving the per-batch query upload
    # (queries carry bf16 rounding); "int8" ships per-query max-abs-scaled
    # codes + one f32 scale (~1/4 of f32 bytes) and dequantizes inside the
    # search jit.  Either way results are the exact
    # search at the rounded coordinates, differing only in near-ties;
    # None (default) keeps the exact f32 wire.
    query_wire: Optional[str] = None

    def validate(self) -> None:
        if self.query_wire not in (None, "float32", "bfloat16", "int8"):
            raise ValueError(
                "search.query_wire must be None, 'float32', 'bfloat16', "
                "or 'int8'"
            )
        if self.slab_growth_slots < 0:
            raise ValueError("search.slab_growth_slots must be >= 0")
        if self.nprobe is not None and self.nprobe <= 0:
            raise ValueError("search.nprobe must be > 0")
        if self.prune_factor is not None and self.prune_factor < 1.0:
            raise ValueError("search.prune_factor must be >= 1.0")
        if self.query_batch_size <= 0:
            raise ValueError("search.query_batch_size must be > 0")


@dataclasses.dataclass
class Config:
    """Mirror of Config (config.rs:14-19)."""

    distance_metric: str = "Euclidean"
    initialization_method: str = "Random"
    initial_k: int = 4
    output_path: str = "data"
    data_file: Optional[str] = None
    desired_cluster_size: Optional[int] = None  # None -> round(0.18 * n)
    rng_seed: Optional[int] = None
    replication: str = "final"  # "final" (SPANN replica pass) | "nested" (reference parity)
    # Closure-replica knobs (the replication/recall/HBM frontier — see the
    # sweep): a point replicates into cluster j only when
    # d(p, c_j) < boundary_threshold * d(p, c_base), and a cluster accepts
    # replicas only up to ceil(replica_overflow * cap) total members.
    # max_replicas=4: on the 1M bench mixture it stores x2.6 (vs x3.2 at 8)
    # and holds recall 0.915 @ nprobe=8; published SPANN configs sit
    # ~x1.5-2.
    max_replicas: int = 4
    boundary_threshold: float = 1.1
    replica_overflow: float = 1.25
    max_split_ways: int = 8  # children per subdivision round (2 = binary parity)
    # SOAR replica ranking (ScaNN's spilled orthogonality-amplified
    # residuals): > 0 ranks admitted closure candidates by
    # D + lambda (r_j.r_1)^2/|r_1|^2 — replicas whose residual is orthogonal
    # to the primary's recover more recall per stored copy.  Euclidean only.
    # None = AUTO: lambda 0.5 on Euclidean, off otherwise — on the 1M bench
    # mixture it added +0.005 to +0.009 recall@nprobe=8 for +1.6% storage.
    # Set 0.0 explicitly for the reference's plain distance ranking.
    soar_lambda: Optional[float] = None
    storage_dtype: str = "float32"  # or "bfloat16"/"int8" for lean indexes
    # Out-of-core build (clustering/outofcore.py): when set, the corpus
    # stays host-resident (ndarray/np.memmap) — centroids are learned on a
    # ``build_sample_rows`` seeded sample and the corpus streams through the
    # device in ``build_tile_rows`` tiles.  Enables building indexes whose
    # corpus exceeds device memory (the reference can only SEARCH such corpora).
    build_sample_rows: Optional[int] = None
    build_tile_rows: Optional[int] = None
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)

    # -- constructors ------------------------------------------------------

    _TOP_KEYS = frozenset({
        "output_path", "data_file", "storage_dtype",
        "build_sample_rows", "build_tile_rows",
    })
    _CP_KEYS = frozenset({
        "distance_metric", "initialization_method", "initial_k",
        "desired_cluster_size", "rng_seed", "replication", "max_replicas",
        "boundary_threshold", "replica_overflow", "max_split_ways",
        "soar_lambda",
    })
    _SC_KEYS = frozenset({
        "nprobe", "prune_factor", "query_batch_size",
        "slab_growth_slots", "query_wire",
    })

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        raw = dict(raw or {})
        cp = dict(raw.pop("clustering_params", {}) or {})
        sc = dict(raw.pop("search", {}) or {})
        # Retired key of older saved manifests: the search layout is chosen
        # from the index's state (SpannIndex.search_layout).
        sc.pop("engine", None)
        # Reject unknown keys instead of silently ignoring them: a typo'd
        # section name ("clustering" for "clustering_params") used to build
        # an UNSEEDED default-capped index with no error — two tests in this
        # repo did exactly that for a round.  Mirrors the reference's strict
        # config validation posture (config.rs:59-87).
        for name, got, ok in (
            ("config", raw.keys(), cls._TOP_KEYS),
            ("clustering_params", cp.keys(), cls._CP_KEYS),
            ("search", sc.keys(), cls._SC_KEYS),
        ):
            unknown = sorted(set(got) - ok)
            if unknown:
                raise ValueError(
                    f"unknown {name} key(s) {unknown}; valid: {sorted(ok)}"
                )
        cfg = cls(
            distance_metric=cp.get("distance_metric", "Euclidean"),
            initialization_method=cp.get("initialization_method", "Random"),
            initial_k=int(cp.get("initial_k", 4)),
            output_path=raw.get("output_path", "data"),
            data_file=raw.get("data_file"),
            desired_cluster_size=cp.get("desired_cluster_size"),
            rng_seed=cp.get("rng_seed"),
            replication=cp.get("replication", "final"),
            max_replicas=int(cp.get("max_replicas", 4)),
            boundary_threshold=float(cp.get("boundary_threshold", 1.1)),
            replica_overflow=float(cp.get("replica_overflow", 1.25)),
            max_split_ways=int(cp.get("max_split_ways", 8)),
            soar_lambda=(
                float(cp["soar_lambda"])
                if cp.get("soar_lambda") is not None
                else None
            ),
            storage_dtype=raw.get("storage_dtype", "float32"),
            build_sample_rows=(
                int(raw["build_sample_rows"])
                if raw.get("build_sample_rows") is not None
                else None
            ),
            build_tile_rows=(
                int(raw["build_tile_rows"])
                if raw.get("build_tile_rows") is not None
                else None
            ),
            search=SearchConfig(
                nprobe=sc.get("nprobe"),
                prune_factor=sc.get("prune_factor"),
                query_batch_size=int(sc.get("query_batch_size", 4096)),
                slab_growth_slots=int(sc.get("slab_growth_slots", 16)),
                query_wire=sc.get("query_wire"),
            ),
        )
        cfg.validate()
        return cfg

    @classmethod
    def from_file(cls, path: str | os.PathLike) -> "Config":
        """Config::from_file (config.rs:52-57).  ``.json`` files need only
        the standard library; anything else is read as YAML (PyYAML)."""
        with open(path, "r") as f:
            if str(path).endswith(".json"):
                raw = json.load(f)
            else:
                import yaml

                raw = yaml.safe_load(f)
        return cls.from_dict(raw or {})

    # -- validation / conversion ------------------------------------------

    def validate(self) -> None:
        """Config::validate (config.rs:59-87): whitelists + positivity."""
        canonical_metric(self.distance_metric)
        canonical_init(self.initialization_method)
        if self.initial_k <= 0:
            raise ValueError("initial_k must be greater than 0")
        if self.desired_cluster_size is not None and self.desired_cluster_size <= 0:
            raise ValueError("desired_cluster_size must be greater than 0")
        if self.storage_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                "storage_dtype must be 'float32', 'bfloat16' or 'int8'"
            )
        if self.soar_lambda is not None:
            if self.soar_lambda < 0:
                raise ValueError("soar_lambda must be >= 0")
            if self.soar_lambda and canonical_metric(self.distance_metric) != "Euclidean":
                raise ValueError("soar_lambda requires the Euclidean metric")
        if self.build_sample_rows is not None and self.build_sample_rows <= 0:
            raise ValueError("build_sample_rows must be greater than 0")
        if self.build_tile_rows is not None and self.build_tile_rows <= 0:
            raise ValueError("build_tile_rows must be greater than 0")
        self.search.validate()

    def to_clustering_params(self) -> ClusteringParams:
        """Config::to_clustering_params (config.rs:90-113)."""
        return ClusteringParams(
            metric=canonical_metric(self.distance_metric),
            initialization_method=canonical_init(self.initialization_method),
            desired_cluster_size=self.desired_cluster_size,
            initial_k=self.initial_k,
            rng_seed=self.rng_seed,
            replication=self.replication,
            max_replicas=self.max_replicas,
            boundary_threshold=self.boundary_threshold,
            replica_overflow=self.replica_overflow,
            max_split_ways=self.max_split_ways,
            # None = auto (see the field comment): SOAR on by default for
            # Euclidean builds, structurally off for L1/Linf.
            soar_lambda=(
                self.soar_lambda
                if self.soar_lambda is not None
                else (
                    0.5
                    if canonical_metric(self.distance_metric) == "Euclidean"
                    else None
                )
            ),
            # Non-f32-storage indexes also ship the BUILD corpus over the
            # wire in bf16 (the index serves rounded vectors either way);
            # halves the dominant one-time upload of large builds.  int8
            # storage still builds in bf16/f32 — quantization applies only
            # at the serving view, never to clustering math.
            wire_dtype=(
                "bfloat16" if self.storage_dtype != "float32" else None
            ),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "clustering_params": {
                "distance_metric": self.distance_metric,
                "initialization_method": self.initialization_method,
                "initial_k": self.initial_k,
                "desired_cluster_size": self.desired_cluster_size,
                "rng_seed": self.rng_seed,
                "replication": self.replication,
                "max_replicas": self.max_replicas,
                "boundary_threshold": self.boundary_threshold,
                "replica_overflow": self.replica_overflow,
                "max_split_ways": self.max_split_ways,
                "soar_lambda": self.soar_lambda,
            },
            "output_path": self.output_path,
            "data_file": self.data_file,
            "storage_dtype": self.storage_dtype,
            "build_sample_rows": self.build_sample_rows,
            "build_tile_rows": self.build_tile_rows,
            "search": {
                "nprobe": self.search.nprobe,
                "prune_factor": self.search.prune_factor,
                "query_batch_size": self.search.query_batch_size,
                "slab_growth_slots": self.search.slab_growth_slots,
                "query_wire": self.search.query_wire,
            },
        }

    def __str__(self) -> str:  # Display parity (config.rs:21-48)
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)
