"""Host<->device transfer accounting.

Every GB-scale transfer in the build path routes through ``timed_put`` and
``timed_pull``, so a build can report how its wall time splits:

    build_wall_s  = what a stopwatch saw
    build_xfer_s  = seconds spent purely copying bytes between host and
                    device (``STATS.total_s``)

and how many bytes moved each way.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import numpy as np


@dataclasses.dataclass
class TransferStats:
    """Accumulated transfer walls/bytes since the last ``reset()``."""

    h2d_bytes: int = 0
    h2d_s: float = 0.0
    n_h2d: int = 0
    d2h_bytes: int = 0
    d2h_s: float = 0.0
    n_d2h: int = 0

    @property
    def total_s(self) -> float:
        return self.h2d_s + self.d2h_s

    def reset(self) -> None:
        self.h2d_bytes = self.d2h_bytes = self.n_h2d = self.n_d2h = 0
        self.h2d_s = self.d2h_s = 0.0

    def account_h2d(self, nbytes: int, seconds: float) -> None:
        self.h2d_bytes += int(nbytes)
        self.h2d_s += seconds
        self.n_h2d += 1

    def account_d2h(self, nbytes: int, seconds: float) -> None:
        self.d2h_bytes += int(nbytes)
        self.d2h_s += seconds
        self.n_d2h += 1

    def as_dict(self) -> dict:
        return {
            "h2d_mb": round(self.h2d_bytes / 2**20, 1),
            "h2d_s": round(self.h2d_s, 2),
            "n_h2d": self.n_h2d,
            "d2h_mb": round(self.d2h_bytes / 2**20, 1),
            "d2h_s": round(self.d2h_s, 2),
            "n_d2h": self.n_d2h,
        }


#: Global accumulator — the bench resets it around the build and reads the
#: split out; zero overhead for callers that never look at it.
STATS = TransferStats()


def timed_put(x, device=None) -> jax.Array:
    """``device_put`` + block, accounted as pure H2D wall.

    Blocking serializes the upload against the next dispatch — the price of
    attributing the copy's time to the copy instead of smearing it into
    whichever kernel happened to wait.
    """
    x = np.asarray(x)
    t0 = time.perf_counter()
    y = jax.device_put(x, device) if device is not None else jax.device_put(x)
    y.block_until_ready()
    STATS.account_h2d(x.nbytes, time.perf_counter() - t0)
    return y


def timed_pull(x) -> np.ndarray:
    """Device->host copy, accounted as pure D2H wall.

    Waits for the producing computation FIRST (that wall belongs to the
    kernel, and the caller's phase timer already holds it), then times only
    the byte movement.
    """
    x = jax.block_until_ready(x)
    t0 = time.perf_counter()
    out = np.asarray(x)
    STATS.account_d2h(out.nbytes, time.perf_counter() - t0)
    return out
