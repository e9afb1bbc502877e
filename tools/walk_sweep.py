#!/usr/bin/env python
"""Leaf size and launch shape of the GPU mesh kernel, swept on the card.

For each BVH leaf size in {1, 2, 4, 8} (the loader's MAX_LEAF) it loads
teapot and alien at their checked-in 800x800 d4 configs and times, in one
process:
  - the kernel alone on 640,000 primary rays and the same lanes after one
    diffuse bounce, for several (rays per program, warps) launch shapes;
  - the whole frame (render_chunk, kernel path), ms/frame.
Prints one line per measurement; medians of `--reps` runs. Needs a GPU.

Usage: python tools/walk_sweep.py [--leaves 1,2,4,8] [--reps 5]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = ((64, 2), (128, 4), (128, 2), (256, 4), (256, 8))


def median_ms(fn, reps):
    import jax
    import numpy as np

    jax.block_until_ready(fn())                # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ts)), ts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--leaves", default="1,2,4,8")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import chip_smoke
    from pathtracer_tpu.engine.wavefront import render_chunk, zero_accum
    from pathtracer_tpu.ops import bvh_walk
    from pathtracer_tpu.scene import loader
    from pathtracer_tpu.scene.fixtures import scene_path
    from pathtracer_tpu.utils.compile_cache import enable_compile_cache
    from pathtracer_tpu.utils.device import gpu_identity, require_gpu

    require_gpu()
    enable_compile_cache()
    print(gpu_identity(), flush=True)
    for leaf in (int(x) for x in args.leaves.split(",")):
        loader.MAX_LEAF = leaf
        for name in ("teapot", "animal"):
            scene, settings = loader.load_scene(scene_path(name))
            pools = chip_smoke.ray_pools(scene, settings)
            n_nodes = scene.bvh.tri_count.shape[0]
            for pool, (o, d, act) in zip(("primary", "bounce"), pools):
                for block, warps in SHAPES:
                    f = jax.jit(lambda sc, o, d, a, block=block, warps=warps:
                                bvh_walk.walk_closest(
                                    sc.walk_nodes, sc.walk_tris, o, d, a,
                                    jnp.full(a.shape, 3.4e38, jnp.float32),
                                    block=block, num_warps=warps,
                                    interpret=settings.interpret))
                    ms, ts = median_ms(lambda: f(scene, o, d, act), args.reps)
                    print(f"leaf {leaf} {name} ({n_nodes} nodes) {pool} "
                          f"block {block} warps {warps}: kernel {ms:.3f} ms "
                          f"{[round(t, 3) for t in ts]}", flush=True)
            n_iters = 4
            ms, ts = median_ms(lambda: render_chunk(
                scene, settings, zero_accum(settings), jnp.int32(1), n_iters,
                0, True), args.reps)
            print(f"leaf {leaf} {name} frame: {ms / n_iters:.3f} ms/frame "
                  f"{[round(t / n_iters, 3) for t in ts]}", flush=True)


if __name__ == "__main__":
    main()
