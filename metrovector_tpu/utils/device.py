"""What the entry points report about the accelerator they run on.

``require_gpu`` refuses to run anywhere but a GPU (benchmarks and
``chip_smoke.py`` must never shrink to a CPU smoke run), and
``card_info`` reads the card's name and power limit, which go beside every
number a run prints: a card held below its maximum power runs slower under
load.
"""

from __future__ import annotations

import subprocess

#: what ``card_info`` reports when ``nvidia-smi`` cannot be read
UNKNOWN_CARD = "card name and power limit not available"


def card_info() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (one line per card, as printed), or :data:`UNKNOWN_CARD`."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return UNKNOWN_CARD
    text = out.stdout.strip()
    return text if out.returncode == 0 and text else UNKNOWN_CARD


def device_summary() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's default backend."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """:func:`device_summary`, or ``SystemExit`` (non-zero) when JAX's
    default backend is not a GPU."""
    dev = device_summary()
    if dev["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {dev['platform']!r} "
            f"({dev['kind']}); this entry point runs on a GPU only"
        )
    return dev
