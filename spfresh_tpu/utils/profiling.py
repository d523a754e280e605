"""Tracing / profiling utilities (SURVEY.md section 5: the reference has only
`log` macros and ad-hoc external flamegraphs; the equivalent here is
jax.profiler traces plus in-process phase timing)."""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import jax

log = logging.getLogger(__name__)


class PhaseTimer:
    """Accumulating wall-clock timer keyed by phase name.

    >>> timer = PhaseTimer()
    >>> with timer.phase("build/assign"):
    ...     do_work()
    >>> timer.report()
    """

    def __init__(self):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block: bool = False) -> Iterator[None]:
        """Time a phase.  ``block=True`` waits for outstanding device work
        first/after so async dispatch doesn't land in the wrong bucket."""
        if block:
            jax.effects_barrier()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block:
                jax.effects_barrier()
            dt = time.perf_counter() - t0
            self._totals[name] += dt
            self._counts[name] += 1

    def totals(self) -> List[Tuple[str, float, int]]:
        return sorted(
            ((k, v, self._counts[k]) for k, v in self._totals.items()),
            key=lambda t: -t[1],
        )

    def report(self, logger: Optional[logging.Logger] = None) -> str:
        lines = [
            f"{name:<40s} {total:8.3f}s  ({count}x, {total / count * 1e3:8.2f} ms avg)"
            for name, total, count in self.totals()
        ]
        text = "\n".join(lines)
        (logger or log).info("phase timings:\n%s", text)
        return text

    def reset(self) -> None:
        self._totals.clear()
        self._counts.clear()


@contextlib.contextmanager
def device_trace(out_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace viewable in TensorBoard / Perfetto."""
    jax.profiler.start_trace(out_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in profiler traces (TraceAnnotation)."""
    with jax.profiler.TraceAnnotation(name):
        yield
