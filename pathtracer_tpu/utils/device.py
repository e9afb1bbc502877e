"""Which device a measurement ran on.

Every timing this repository prints names its device. A measurement path
that finds no GPU fails; it never falls back to the CPU.
"""
from __future__ import annotations

import subprocess


def gpu_identity() -> str:
    """The card's name and power limit, as `nvidia-smi` reports them (one
    line per card). Runs in a child process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def require_gpu():
    """JAX's devices, or RuntimeError when the default backend is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {devs[0].platform!r}")
    return devs


def device_record(devs) -> dict:
    """{"platform", "kind", "count"} as JAX reports the devices."""
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
