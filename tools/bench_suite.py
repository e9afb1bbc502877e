#!/usr/bin/env python
"""Full benchmark suite — reproduces the reference's README measurement
matrix (BASELINE.md) on one GPU and writes BENCH.md + BENCH.json, headed by
the card's name and power limit.

Covers: Cornell defaults + feature ablations (AA, DoF, material sort,
threefry RNG, depth quirk), open scene, both engines, and the mesh scenes
(teapot / cow / alien via their JSON configs).

Usage: python tools/bench_suite.py [--quick]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pathtracer_tpu.scene.fixtures import scene_path
BASELINES_MS = {  # reference published numbers (BASELINE.md).
    # Mesh-row caveat: the reference's BVH table times (README.md:314-321)
    # were measured at those scenes' checked-in configs (800x800 d4 for
    # teapot/alien); cow has no checked-in reference scene, so its 19 ms is
    # the closest published number (BVH SAH table) — treat as indicative.
    "cornell defaults": 35.18,
    "cornell + material sort": 42.95,
    "teapot d4": 17.0,
    "cow d4": 19.0,
    "alien d4": 22.0,
}


def bench_wavefront(scene, settings, chunk=30, reps=3, seed=0):
    import jax
    import jax.numpy as jnp

    from pathtracer_tpu.engine.wavefront import render_chunk, zero_accum

    accum = zero_accum(settings)
    accum = render_chunk(scene, settings, accum, jnp.int32(1), chunk, seed,
                         True)
    jax.block_until_ready(accum)
    best, it = float("inf"), 1 + chunk
    for _ in range(reps):
        t0 = time.perf_counter()
        accum = render_chunk(scene, settings, accum, jnp.int32(it), chunk,
                             seed, True)
        jax.block_until_ready(accum)
        best = min(best, (time.perf_counter() - t0) / chunk)
        it += chunk
    return best * 1e3


def bench_persistent(scene, settings, chunk=30, reps=3, seed=0):
    import jax
    import jax.numpy as jnp

    from pathtracer_tpu.engine.persistent import (fresh_lanes, pixel_stride,
                                                  render_persistent_chunk)

    state = fresh_lanes(settings)
    stride = pixel_stride(settings.pixel_count)
    state = render_persistent_chunk(scene, settings, state, jnp.int32(chunk),
                                    seed, stride)
    jax.block_until_ready(state)
    best, target = float("inf"), chunk
    for _ in range(reps):
        target += chunk
        t0 = time.perf_counter()
        state = render_persistent_chunk(scene, settings, state,
                                        jnp.int32(target), seed, stride)
        jax.block_until_ready(state)
        best = min(best, (time.perf_counter() - t0) / chunk)
    return best * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="skip the slow mesh configs")
    ap.add_argument("--out", default="BENCH.md")
    args = ap.parse_args()

    from pathtracer_tpu import load_scene
    from pathtracer_tpu.utils.compile_cache import enable_compile_cache
    from pathtracer_tpu.utils.device import gpu_identity, require_gpu

    require_gpu()
    enable_compile_cache()
    card = gpu_identity()
    print(card)
    rows = []

    def run(name, path, fn=bench_wavefront, overrides=None, chunk=30, **kw):
        scene, settings = load_scene(path, overrides=overrides)
        if kw:
            settings = dataclasses.replace(settings, **kw)
        ms = fn(scene, settings, chunk=chunk)
        base = BASELINES_MS.get(name)
        mrays = settings.pixel_count / ms / 1e3   # primary Mrays/s
        rows.append({"config": name, "ms_per_frame": round(ms, 3),
                     "primary_mrays_per_s": round(mrays, 1),
                     "reference_ms": base,
                     "speedup_vs_reference":
                         round(base / ms, 2) if base else None})
        print(f"{name}: {ms:.3f} ms  {mrays:.1f} Mrays/s"
              + (f"  ({base / ms:.2f}x ref)" if base else ""))

    cornell = scene_path("cornell")
    open_sc = scene_path("open_test_scene")

    run("cornell defaults", cornell)
    run("cornell persistent engine", cornell, fn=bench_persistent)
    run("cornell no AA", cornell, jitter=False)
    run("cornell no DoF", cornell, dof=False)
    run("cornell + material sort", cornell, sort_materials=True, chunk=10)
    run("cornell threefry RNG", cornell, fast_rng=False)
    run("cornell depth quirk", cornell, depth_quirk=True)
    run("open scene", open_sc, overrides={"RES": [800, 800], "DEPTH": 8})
    run("open scene persistent engine", open_sc, fn=bench_persistent,
        overrides={"RES": [800, 800], "DEPTH": 8})

    if not args.quick:
        run("teapot d4", scene_path("teapot"), chunk=3)
        run("cow d4", scene_path("cow"), chunk=3)
        run("alien d4", scene_path("animal"), chunk=3)
        run("alien d4 persistent engine", scene_path("animal"),
            fn=bench_persistent, chunk=32)
        # the plain-XLA mesh walk, for comparison with the GPU kernel
        run("teapot d4 XLA walk", scene_path("teapot"), chunk=3,
            bvh_impl="jnp")

    with open(args.out.replace(".md", ".json"), "w") as f:
        json.dump(rows, f, indent=1)
    with open(args.out, "w") as f:
        f.write(f"# BENCH — measured on one GPU: {card}\n\n")
        f.write("Reference baselines: RTX 3060 Laptop (BASELINE.md). "
                "ms/frame = one full progressive iteration at the scene's "
                "configured resolution and depth.\n\n")
        f.write("| Config | ms/frame | primary Mrays/s | reference ms "
                "| speedup |\n")
        f.write("|---|---|---|---|---|\n")
        for r in rows:
            ref = r["reference_ms"] or "—"
            spd = f"{r['speedup_vs_reference']}x" if r[
                "speedup_vs_reference"] else "—"
            f.write(f"| {r['config']} | {r['ms_per_frame']} | "
                    f"{r['primary_mrays_per_s']} | {ref} | {spd} |\n")
    print(f"wrote {args.out} and {args.out.replace('.md', '.json')}")


if __name__ == "__main__":
    main()
