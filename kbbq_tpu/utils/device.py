"""What a measurement runs on: JAX's device, and the card's own report.

Every number a benchmark prints names its device (`device_info`), and a
measurement that finds no GPU fails (`require_gpu`) instead of timing
the CPU backend under a device metric's name.
"""

from __future__ import annotations

import subprocess
import sys


def device_info() -> dict:
    """{platform, kind, count} of JAX's default backend."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(tool: str) -> dict:
    """device_info(), or exit 2 when JAX's default backend is no GPU."""
    info = device_info()
    if info["platform"] != "gpu":
        print(f"{tool}: needs a GPU; JAX found {info['platform']} "
              f"({info['kind']!r}), refusing to measure it",
              file=sys.stderr)
        raise SystemExit(2)
    return info


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, one
    line each (the power limit bounds the clocks under load, so it goes
    beside every number taken on the card)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()
