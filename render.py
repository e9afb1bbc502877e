#!/usr/bin/env python
"""CLI renderer — the analogue of the reference app's batch path
(main.cpp:341-393 minus the GL window): load scene, render, save PNG.

Usage: python render.py scenes/cornell.json [--res 256] [--spp 64]
       [--depth 4] [--out out.png] [--seed 0] [--no-compact] [--sort]
"""
from __future__ import annotations

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--res", type=int, default=None, help="override square resolution")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None, help="override ITERATIONS")
    ap.add_argument("--depth", type=int, default=None, help="override DEPTH")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--no-jitter", action="store_true")
    ap.add_argument("--no-dof", action="store_true")
    ap.add_argument("--no-early-exit", action="store_true")
    ap.add_argument("--hdr", action="store_true", help="also save .hdr")
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="checkpoint file: resumes from it if present, and "
                         "saves to it after rendering")
    ap.add_argument("--bvh", choices=("triton", "jnp"), default=None,
                    help="mesh intersector override (default: the loader's "
                         "pick for the platform; scene/loader.py)")
    ap.add_argument("--engine", choices=("wavefront", "persistent"),
                    default="wavefront",
                    help="wavefront: masked fixed-pool bounce loop (fastest "
                         "for closed scenes). persistent: rotating work-queue "
                         "lanes (fastest for open scenes; identical images)")
    args = ap.parse_args()

    import dataclasses

    import jax.numpy as jnp

    from pathtracer_tpu import load_scene, render
    from pathtracer_tpu.io.image import reference_style_name, save_hdr, save_png
    from pathtracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    overrides = {}
    if args.res is not None:
        overrides["RES"] = [args.res, args.res]
    if args.width is not None or args.height is not None:
        overrides["RES"] = [args.width or args.res, args.height or args.res]
    if args.spp is not None:
        overrides["ITERATIONS"] = args.spp
    if args.depth is not None:
        overrides["DEPTH"] = args.depth

    scene, settings = load_scene(args.scene, overrides=overrides or None)
    if args.no_jitter or args.no_dof:
        settings = dataclasses.replace(
            settings, jitter=not args.no_jitter, dof=not args.no_dof)
    if args.bvh:
        settings = dataclasses.replace(settings, bvh_impl=args.bvh)

    print(f"scene: {args.scene}  {settings.width}x{settings.height} "
          f"depth={settings.trace_depth} spp={settings.iterations} "
          f"geoms={len(settings.geom_types)} "
          f"tris={scene.triangles.v0x.shape[0]}")

    start_iteration, accum = 0, None
    if args.checkpoint:
        import os as _os
        if _os.path.exists(args.checkpoint):
            from pathtracer_tpu.utils.checkpoint import load_checkpoint
            accum, start_iteration, ck_seed = load_checkpoint(
                args.checkpoint, settings)
            args.seed = ck_seed
            print(f"resuming from {args.checkpoint} at "
                  f"{start_iteration} spp")

    t0 = time.perf_counter()
    final = {}
    if args.engine == "persistent":
        # persistent chunks fully drain (engine/persistent.fresh_lanes), so
        # every chunk boundary is a clean checkpoint — same contract as the
        # wavefront engine's accumulation checkpoints.
        from pathtracer_tpu.engine.persistent import render_persistent
        img = render_persistent(scene, settings, seed=args.seed,
                                chunk=max(args.chunk, 32),
                                accum=accum, start_iteration=start_iteration,
                                progress=lambda done, a: final.update(
                                    done=done, accum=a))
    else:
        # capture the final LANE-SPACE accumulation for checkpointing (the
        # returned image is unmapped to row-major pixel order)
        img = render(scene, settings, seed=args.seed, chunk=args.chunk,
                     early_exit=not args.no_early_exit,
                     accum=accum, start_iteration=start_iteration,
                     progress=lambda done, a: final.update(done=done, accum=a))
    dt = time.perf_counter() - t0  # render() returns a host ndarray
    n_rays = settings.pixel_count * settings.iterations
    print(f"rendered in {dt:.2f}s  "
          f"({1e3 * dt / settings.iterations:.2f} ms/iter, "
          f"{n_rays / dt / 1e6:.1f}M primary rays/s)")

    if args.checkpoint and final:
        from pathtracer_tpu.utils.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, final["accum"], final["done"],
                        settings, seed=args.seed)
        print(f"checkpoint -> {args.checkpoint} ({final['done']} spp)")

    total_spp = start_iteration + settings.iterations
    out = args.out or reference_style_name(settings.image_name, total_spp)
    save_png(img, out)
    print(f"saved {out}")
    if args.hdr:
        save_hdr(img, out.rsplit(".", 1)[0] + ".hdr")


if __name__ == "__main__":
    main()
