#!/usr/bin/env python
"""Headline benchmark — prints ONE JSON line.

Headline metric: Cornell 800x800 depth-8 ms/frame on one GPU vs the
reference CUDA tracer's published 35.18 ms/frame at identical config
(RTX 3060 Laptop, BASELINE.md "Frame time, defaults"). vs_baseline is
our_value / baseline (< 1.0 means faster than the reference).

The "extra" field carries the material-sorted Cornell row and the
mesh-scene rows (teapot / alien at their checked-in 800x800 d4 configs vs
the reference's 17 / 22 ms BVH-SAH numbers, BASELINE.md) and primary-rays/s
throughput for each scene. Scenes resolve from the repo's own scenes/
(self-contained; see pathtracer_tpu/scene/fixtures.py).

Needs a GPU; the card's name and power limit print first, the JSON line
last. A failing cell fails the run.
"""
from __future__ import annotations

import json
import sys
import time

BASELINE_MS = 35.18   # Cornell 800x800 d8, compaction on, AA off
TEAPOT_REF_MS = 17.0  # BASELINE.md BVH SAH table
ALIEN_REF_MS = 22.0


def bench(scene, settings, chunk, warmup=2, reps=3):
    import jax
    import jax.numpy as jnp

    from pathtracer_tpu.engine.wavefront import render_chunk, zero_accum

    accum = zero_accum(settings)
    it = 1
    for _ in range(warmup):
        accum = render_chunk(scene, settings, accum, jnp.int32(it), chunk,
                             0, True)
        jax.block_until_ready(accum)
        it += chunk
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        accum = render_chunk(scene, settings, accum, jnp.int32(it), chunk,
                             0, True)
        jax.block_until_ready(accum)
        best = min(best, (time.perf_counter() - t0) / chunk)
        it += chunk
    return best * 1e3


def main():
    from pathtracer_tpu import load_scene
    from pathtracer_tpu.scene.fixtures import scene_path
    from pathtracer_tpu.utils.compile_cache import enable_compile_cache
    from pathtracer_tpu.utils.device import (device_record, gpu_identity,
                                             require_gpu)

    devs = require_gpu()
    enable_compile_cache()
    print(gpu_identity(), file=sys.stderr)

    scene, settings = load_scene(scene_path("cornell"))
    assert settings.width == 800 and settings.trace_depth == 8
    cornell_ms = bench(scene, settings, chunk=50)

    extra = {
        "cornell_mrays_s": round(settings.pixel_count / cornell_ms / 1e3, 1),
    }
    # COALESCED material sort (reference: 42.95 ms at the same config —
    # BASELINE.md "Material sort")
    import dataclasses
    s_sorted = dataclasses.replace(settings, sort_materials=True)
    ms = bench(scene, s_sorted, chunk=10, warmup=1, reps=2)
    extra["cornell_sorted_ms_per_frame"] = round(ms, 3)
    extra["cornell_sorted_vs_ref"] = round(ms / 42.95, 3)
    for name, ref_ms in (("teapot", TEAPOT_REF_MS), ("animal", ALIEN_REF_MS)):
        scene, settings = load_scene(scene_path(name))
        ms = bench(scene, settings, chunk=4, warmup=1, reps=2)
        extra[f"{name}_ms_per_frame"] = round(ms, 3)
        extra[f"{name}_vs_ref"] = round(ms / ref_ms, 3)
        extra[f"{name}_mrays_s"] = round(settings.pixel_count / ms / 1e3, 1)

    print(json.dumps({
        "metric": "cornell_800x800_d8_ms_per_frame",
        "value": round(cornell_ms, 3),
        "unit": "ms",
        "vs_baseline": round(cornell_ms / BASELINE_MS, 4),
        "device": device_record(devs),
        "extra": extra,
    }))


if __name__ == "__main__":
    sys.exit(main())
