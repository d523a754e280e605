"""The GPU's name and power limit, for every line that carries a number."""

from __future__ import annotations

import subprocess


def card_name() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    one entry per distinct card, joined by " | "."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return " | ".join(dict.fromkeys(lines))
