"""The one table of route choices, keyed by JAX platform.

Tests run on the CPU backend; deployments run on NVIDIA GPUs.  Every choice
of implementation that depends on the device reads this table, and any
other platform is refused rather than guessed at.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax


@dataclasses.dataclass(frozen=True)
class Routes:
    # Build: keep subdivision membership on the device (one assignment
    # vector) instead of uploading member tables per level.
    resident_subdivision: bool
    # Build: scale the host-tail row threshold by 128/d (see
    # clustering/hierarchical.py ``_tail_rows_for``).
    host_tail_scaled: bool


ROUTES = {
    "cpu": Routes(
        resident_subdivision=False,
        host_tail_scaled=False,
    ),
    "gpu": Routes(
        resident_subdivision=True,
        host_tail_scaled=True,
    ),
}


def routes(platform: Optional[str] = None) -> Routes:
    """Routes for ``platform`` (default: that of the first JAX device)."""
    if platform is None:
        platform = jax.devices()[0].platform
    try:
        return ROUTES[platform]
    except KeyError:
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}: spfresh_tpu runs on "
            f"{sorted(ROUTES)}"
        ) from None
