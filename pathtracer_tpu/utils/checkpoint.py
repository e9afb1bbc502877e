"""Render checkpoint/resume — deterministic restartability (SURVEY.md §5).

The reference's only persistent state is the progressive accumulation
(dev_image running sum + iteration count, reset on camera change,
main.cpp:423-452); it cannot resume a render across process restarts. Here a
checkpoint captures (accumulation sum, iterations done, seed, settings
fingerprint) so a render can continue exactly where it stopped: the RNG is a
pure function of (seed, iteration, pixel) (ops/rng.py), so resume produces
THE SAME image as an uninterrupted run (tested).

Format: a single .npz — no framework dependency, readable anywhere.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np

from ..scene.types import RenderSettings
from ..utils.vec import Vec3

FORMAT_VERSION = 1


def _fingerprint(settings: RenderSettings) -> str:
    """Settings that affect the accumulated estimate (not perf knobs)."""
    # rr_start changes the estimator (Russian roulette on/off mid-render
    # would mix two estimators); bvh_impl keeps a resumed render on the same
    # mesh traversal (float contraction differs between kernel and XLA).
    keep = ("width", "height", "trace_depth", "jitter", "dof", "fast_rng",
            "depth_quirk", "geom_types", "any_glossy", "any_refractive",
            "rr_start", "bvh_impl")
    d = {k: getattr(settings, k) for k in keep}
    return json.dumps(d, sort_keys=True, default=list)


def save_checkpoint(path: str, accum: Vec3, iterations_done: int,
                    settings: RenderSettings, seed: int = 0) -> str:
    """Write (accum sum, iteration, seed) — resumable and inspectable."""
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        accum_x=np.asarray(accum.x), accum_y=np.asarray(accum.y),
        accum_z=np.asarray(accum.z),
        iterations_done=iterations_done,
        seed=seed,
        fingerprint=_fingerprint(settings),
    )
    return path


def load_checkpoint(path: str, settings: Optional[RenderSettings] = None
                    ) -> Tuple[Vec3, int, int]:
    """Read a checkpoint; verifies the settings fingerprint when given.

    Returns (accum Vec3, iterations_done, seed).
    """
    import jax.numpy as jnp

    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']}")
        if settings is not None:
            fp = str(z["fingerprint"])
            if fp != _fingerprint(settings):
                raise ValueError(
                    "checkpoint settings mismatch:\n"
                    f"  checkpoint: {fp}\n  current:    "
                    f"{_fingerprint(settings)}")
        accum = Vec3(jnp.asarray(z["accum_x"]), jnp.asarray(z["accum_y"]),
                     jnp.asarray(z["accum_z"]))
        return accum, int(z["iterations_done"]), int(z["seed"])
