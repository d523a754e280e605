"""Fresh-seed fuzz marathon driver (not collected by pytest).

Runs the model-fuzz suites' core loops directly with ARBITRARY seeds —
the CI-pinned parametrizations keep only the catching seeds cheap, while
this driver lets an idle machine grind through hundreds of fresh seeds
between rounds.  Every layer that has found a real bug this way stays in
the rotation.

Usage (on the CPU):

    JAX_PLATFORMS=cpu \
        python tests/marathon.py --seeds 175 250 [--suites storage,view,...]

Prints one ``ok <suite> seed=<s>`` line per execution; exits non-zero on
the first failure, leaving the failing suite+seed on stderr so it can be
pinned as a regression parametrization.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _tmp():
    return tempfile.TemporaryDirectory(prefix="spf_marathon_")


def run_storage(seed: int) -> None:
    import test_storage_model_fuzz as t

    for fn in (t.test_packed_storage_model_fuzz, t.test_ram_storage_model_fuzz):
        with _tmp() as d:
            from pathlib import Path

            fn(Path(d), seed)


def run_fresh(seed: int) -> None:
    import test_fresh_model_fuzz as t

    for sd in ("float32", "int8"):
        with _tmp() as d:
            from pathlib import Path

            t.test_lazy_fresh_model_fuzz(Path(d), seed, sd)


def run_spfresh(seed: int) -> None:
    import test_spfresh_model_fuzz as t

    with _tmp() as d:
        from pathlib import Path

        t.test_spfresh_model_fuzz(Path(d), seed)


def run_view(seed: int) -> None:
    import test_view_update_fuzz as t

    for sd in ("float32", "int8"):
        with _tmp() as d:
            from pathlib import Path

            t.test_view_update_fuzz(Path(d), sd, seed)


def run_mesh(seed: int) -> None:
    import pytest

    import test_mesh_build_fuzz as t

    mp = pytest.MonkeyPatch()
    try:
        t.test_mesh_resident_fuzz_matches_single_device(mp, seed)
    finally:
        mp.undo()


def run_oc(seed: int) -> None:
    import test_outofcore_model_fuzz as t

    with _tmp() as d:
        from pathlib import Path

        t.run_outofcore_model_fuzz(Path(d), seed)


SUITES = {
    "storage": run_storage,
    "fresh": run_fresh,
    "spfresh": run_spfresh,
    "view": run_view,
    "mesh": run_mesh,
    "oc": run_oc,
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", nargs=2, type=int, metavar=("LO", "HI"),
                    required=True, help="half-open seed range [LO, HI)")
    ap.add_argument("--suites", default=",".join(SUITES),
                    help="comma list from: " + ",".join(SUITES))
    args = ap.parse_args()
    suites = [s for s in args.suites.split(",") if s]
    unknown = set(suites) - set(SUITES)
    if unknown:
        ap.error(f"unknown suites: {sorted(unknown)}")
    lo, hi = args.seeds
    ran = 0
    for seed in range(lo, hi):
        for name in suites:
            try:
                SUITES[name](seed)
            except Exception:
                print(f"FAIL {name} seed={seed}", file=sys.stderr, flush=True)
                traceback.print_exc()
                return 1
            ran += 1
            print(f"ok {name} seed={seed}", flush=True)
        # Every seed compiles fresh shapes; after ~150 executions in one
        # process the accumulated executables starved LLVM's allocator
        # ("LLVM compilation error: Cannot allocate memory" killed a run at
        # seed 225).  Dropping the in-memory caches frees them — recompiles
        # mostly reload from the persistent JAX_COMPILATION_CACHE_DIR.
        import jax

        jax.clear_caches()
    print(f"MARATHON DONE executions={ran} fails=0", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
