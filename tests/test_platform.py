"""Platform routes, the compile-cache helper, the no-PyYAML import path and
``chip_smoke.py``'s refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from spfresh_tpu.core.platform import ROUTES, routes
from spfresh_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_route_table_covers_cpu_and_gpu():
    assert set(ROUTES) == {"cpu", "gpu"}
    assert not routes("cpu").resident_subdivision
    assert routes("gpu").resident_subdivision
    assert not routes("cpu").host_tail_scaled
    assert routes("gpu").host_tail_scaled


def test_route_table_refuses_other_platforms():
    with pytest.raises(RuntimeError, match="unsupported JAX platform 'rocm'"):
        routes("rocm")
    assert routes() is ROUTES[jax.devices()[0].platform]


def _small_index(tmp_path, rng):
    import numpy as np

    from spfresh_tpu.index import Config, SpannIndexBuilder

    data = rng.standard_normal((300, 8)).astype(np.float32)
    cfg = Config.from_dict(
        {"clustering_params": {"desired_cluster_size": 40, "rng_seed": 1},
         "output_path": str(tmp_path / "i")}
    )
    return SpannIndexBuilder(cfg).with_data(data).build(save=False), data


def _live_insert(index, vec, vid):
    """Append ``vec`` under id ``vid`` to the first posting, as LIRE does."""
    import numpy as np

    cid = min(index.postings)
    ids, vecs = index.postings[cid]
    index.replace_posting(cid, np.append(ids, vid), np.vstack([vecs, vec]))


def test_search_layout_follows_live_updates(tmp_path, rng):
    """A static index serves from the CSR view; its first live update moves
    search to the slab view, which refreshes in place, and drops the CSR
    snapshot.  Results stay exact across the switch."""
    index, data = _small_index(tmp_path, rng)
    assert index.search_layout() == "csr"
    ids, _ = index.search(data[:2], 3, nprobe=index.num_clusters)
    assert list(ids[:, 0]) == [0, 1]
    assert index._padded_view is None and index._view is not None
    new = data[:1] + 0.01
    _live_insert(index, new, 300)
    assert index.search_layout() == "slab"
    ids, _ = index.search(new, 1, nprobe=index.num_clusters)
    assert ids[0, 0] == 300
    assert index._padded_view is not None and index._view is None
    with pytest.raises(ValueError, match="unknown search engine"):
        index.search(data[:2], 3, engine="pallas")


def test_sharded_engine_follows_index_layout(tmp_path, rng):
    from spfresh_tpu.parallel.sharded import ShardedSpannIndex, default_mesh

    index, data = _small_index(tmp_path, rng)
    sharded = ShardedSpannIndex(index, default_mesh())
    forced = ShardedSpannIndex(index, default_mesh(), engine="csr")
    assert sharded.engine == "csr"
    ids, _ = sharded.search(data[:2], 3, nprobe=index.num_clusters)
    assert list(ids[:, 0]) == [0, 1]
    new = data[:1] + 0.01
    _live_insert(index, new, 300)
    assert sharded.engine == "slab" and forced.engine == "csr"
    for s in (sharded, forced):
        ids, _ = s.search(new, 1, nprobe=index.num_clusters)
        assert ids[0, 0] == 300
    assert sharded._view is None and sharded._padded is not None
    with pytest.raises(ValueError, match="unknown engine"):
        ShardedSpannIndex(index, default_mesh(), engine="pallas")


def test_compile_cache_env_unset(monkeypatch):
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_env_set(monkeypatch, tmp_path):
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "/untouched")
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        # The environment wins and nothing else is set.
        assert jax.config.jax_compilation_cache_dir == "/untouched"
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def _run(args, cwd, **env):
    e = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    e.update(env)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=e,
    )


def test_index_imports_without_pyyaml(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(
        {"clustering_params": {"desired_cluster_size": 7, "rng_seed": 3}}
    ))
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "from spfresh_tpu.index import Config\n"
        f"c = Config.from_file({str(cfg)!r})\n"
        "assert c.to_clustering_params().desired_cluster_size == 7\n"
        "print('OK')\n"
    )
    r = _run(["-c", code], REPO, JAX_PLATFORMS="cpu")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "OK"


def test_chip_smoke_refuses_cpu(tmp_path):
    """On the CPU backend the smoke run exits non-zero before any phase and
    never prints the success line; alone in a directory, without the
    package, it fails the same way."""
    r = _run(["chip_smoke.py"], REPO, JAX_PLATFORMS="cpu")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path), JAX_PLATFORMS="cpu")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
