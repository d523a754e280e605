"""Driver entry-point contract tests.

The multi-device dry run proves that the sharded path compiles and
executes on a virtual CPU mesh without touching the default backend.  These
tests pin the contract:

* the in-process dry run works on the virtual CPU mesh;
* a failing in-process run falls back to a clean CPU subprocess;
* ``replicate``/``shard_rows`` place host data directly onto the mesh,
  never via the default backend.
"""

import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])

import __graft_entry__ as graft  # noqa: E402
from spfresh_tpu.parallel import cluster_step  # noqa: E402


def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    ids, dists = out
    assert ids.shape == dists.shape == (16, 10)


def test_dryrun_multichip_inprocess():
    graft._dryrun_multichip_impl(8)


def test_dryrun_falls_back_to_subprocess_when_default_backend_unusable(
    monkeypatch,
):
    """The in-process run dies (here: a simulated backend error from a
    default-backend device_put); the dry run must still succeed via the
    clean re-exec'd CPU subprocess."""
    calls = {"sub": 0}
    real_sub = graft._dryrun_subprocess

    def counting_sub(n):
        calls["sub"] += 1
        real_sub(n)

    def broken_impl(n):
        raise RuntimeError("default backend unusable (simulated)")

    monkeypatch.setattr(graft, "_dryrun_multichip_impl", broken_impl)
    monkeypatch.setattr(graft, "_dryrun_subprocess", counting_sub)
    graft.dryrun_multichip(2)
    assert calls["sub"] == 1


def test_replicate_and_shard_rows_never_stage_via_default_backend(monkeypatch):
    """Host data must be device_put directly onto the mesh.  jnp staging is
    forbidden: patch the module's jnp with a tripwire and verify the helpers
    still work from raw numpy."""

    class TripwireJnp:
        def __getattr__(self, name):
            raise AssertionError(
                f"cluster_step staging used jnp.{name} — host data would be "
                "committed to the default backend"
            )

    monkeypatch.setattr(cluster_step, "jnp", TripwireJnp())
    devices = jax.devices("cpu")
    mesh = Mesh(np.array(devices[:4]), ("shard",))
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    rep = cluster_step.replicate(mesh, x)
    shd = cluster_step.shard_rows(mesh, x)
    np.testing.assert_array_equal(np.asarray(rep), x)
    np.testing.assert_array_equal(np.asarray(shd), x)
    assert {d for d in shd.sharding.device_set} <= set(devices[:4])
    # Committed jax arrays pass through without a host round-trip.
    rep2 = cluster_step.replicate(mesh, rep)
    np.testing.assert_array_equal(np.asarray(rep2), x)
