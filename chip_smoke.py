#!/usr/bin/env python
"""Smoke test of the tracer on one GPU: the quickest proof that the system
starts on the card and gives right answers there.

Phases, all in this one process (each prints one line with its time):
  identity  the card's name and power limit (nvidia-smi)
  cornell   Cornell 800x800 d8: masked, material-sorted and persistent
            engines; the three images agree (pixel-keyed RNG)
  mesh      teapot and alien at their 800x800 d4 configs: the GPU kernel
            against the plain-XLA walk, ms/frame each, interleaved
  agree     kernel vs XLA walk at 640,000 rays (primary rays and one
            diffuse bounce) on teapot and alien, within stated tolerances
  parity    Cornell 800x800 at 1000 spp against the reference's golden
            render, within the tests/test_parity_full.py envelope
  fit       one albedo_fit_step on Cornell 800x800 d8 (the differentiable
            path)
  memory    compiled.memory_analysis() of the alien frame, and the kernel's
            Triton call present in it

The last line of standard output is one JSON object naming the device; it
is printed only when every phase passed. Without a GPU the script exits
non-zero before any phase.

Usage:
  python chip_smoke.py                    # every one-card phase
  python chip_smoke.py --phases mesh,agree
  python chip_smoke.py --four             # four-card path only (4 GPUs)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

PHASES = ("cornell", "mesh", "agree", "parity", "fit", "memory")

# kernel vs XLA walk at 640k rays (float32 throughout; XLA and Triton may
# contract multiply-adds differently, so a grazing ray can flip)
AGREE_MIN_HIT = 0.9999      # share of rays with the same hit/miss
AGREE_MAX_DT_SHARE = 1e-4   # share of both-hit rays with |dt|/t > 1e-5
AGREE_MAX_MAT_SHARE = 1e-4  # share of both-hit rays with another material
# images of the same samples from two engines or two traversals
IMAGE_MAX_DIFF_SHARE = 2e-3  # share of pixels differing by more than 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def _ready(x):
    import jax
    return jax.block_until_ready(x)


def image_agreement(a, b) -> dict:
    import numpy as np
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    px = d.max(axis=-1)
    return {"max": float(d.max()), "mean": float(d.mean()),
            "share_gt_1e-3": float((px > 1e-3).mean())}


def check_image(img, h, w) -> None:
    import numpy as np
    img = np.asarray(img)
    assert img.shape == (h, w, 3), img.shape
    assert np.isfinite(img).all(), "non-finite pixels"
    assert img.mean() > 1e-3, "black image"


def frame_ms(scene, settings, n_iters: int, start: int):
    """Run render_chunk once (n_iters frames) and return ms/frame."""
    import jax.numpy as jnp
    from pathtracer_tpu.engine.wavefront import render_chunk, zero_accum

    accum = zero_accum(settings)
    t0 = time.perf_counter()
    _ready(render_chunk(scene, settings, accum, jnp.int32(start), n_iters,
                        0, True))
    return 1e3 * (time.perf_counter() - t0) / n_iters


def phase_cornell():
    from pathtracer_tpu import load_scene, render
    from pathtracer_tpu.engine.persistent import render_persistent
    from pathtracer_tpu.scene.fixtures import scene_path

    scene, settings = load_scene(scene_path("cornell"))
    assert settings.trace_depth == 8, settings.trace_depth
    spp = 16
    modes = {
        "masked": lambda: render(scene, settings, iterations=spp, chunk=spp),
        "sorted": lambda: render(
            scene, dataclasses.replace(settings, sort_materials=True),
            iterations=spp, chunk=spp),
        "persistent": lambda: render_persistent(
            scene, settings, iterations=spp, chunk=spp),
    }
    imgs = {}
    for name, fn in modes.items():
        fn()                                   # compile
        t0 = time.perf_counter()
        imgs[name] = fn()
        ms = 1e3 * (time.perf_counter() - t0) / spp
        check_image(imgs[name], settings.height, settings.width)
        log(f"  cornell {name}: {ms:.3f} ms/frame ({spp} spp, 800x800 d8)")
    for name in ("sorted", "persistent"):
        a = image_agreement(imgs["masked"], imgs[name])
        log(f"  cornell masked vs {name}: {a}")
        assert a["share_gt_1e-3"] <= IMAGE_MAX_DIFF_SHARE, a


def phase_mesh():
    import numpy as np
    from pathtracer_tpu import load_scene, render
    from pathtracer_tpu.scene.fixtures import scene_path

    for name in ("teapot", "animal"):
        scene, settings = load_scene(scene_path(name))
        assert settings.bvh_impl == "triton", settings.bvh_impl
        impls = {"triton": settings,
                 "jnp": dataclasses.replace(settings, bvh_impl="jnp")}
        n_iters = 2
        for s in impls.values():               # compile both
            frame_ms(scene, s, n_iters, 1)
        times = {k: [] for k in impls}
        for k in ("triton", "jnp", "jnp", "triton", "triton", "jnp"):
            times[k].append(frame_ms(scene, impls[k], n_iters, 1))
        med = {k: float(np.median(v)) for k, v in times.items()}
        log(f"  {name} {settings.width}x{settings.height} "
            f"d{settings.trace_depth}: kernel {med['triton']:.3f} ms/frame "
            f"{times['triton']}, XLA walk {med['jnp']:.3f} ms/frame "
            f"{times['jnp']}")
        imgs = {k: render(scene, s, iterations=4, chunk=4)
                for k, s in impls.items()}
        for img in imgs.values():
            check_image(img, settings.height, settings.width)
        a = image_agreement(imgs["triton"], imgs["jnp"])
        log(f"  {name} image kernel vs XLA walk (4 spp): {a}")
        assert a["share_gt_1e-3"] <= IMAGE_MAX_DIFF_SHARE, a


def ray_pools(scene, settings):
    """Primary rays of the full frame and the same lanes after one bounce."""
    import jax
    import jax.numpy as jnp
    from pathtracer_tpu.engine.wavefront import bounce_step, generate_paths
    from pathtracer_tpu.ops import rng
    from pathtracer_tpu.utils.vec import Vec3

    @jax.jit
    def make(scene):
        irng = rng.IterationRng(True, 0, jnp.int32(1),
                                pixel_map=settings.pixel_map())
        state = generate_paths(scene, settings, irng)
        nxt, _ = bounce_step(scene, settings, irng, jnp.int32(0), state,
                             Vec3.zeros(state.pixel.shape))
        ones = jnp.ones(state.pixel.shape, bool)
        return ((state.origin, state.direction, ones),
                (nxt.origin, nxt.direction, nxt.remaining_bounces > 0))

    return make(scene)


def phase_agree():
    import jax
    import numpy as np
    from pathtracer_tpu import load_scene
    from pathtracer_tpu.ops.intersect import intersect_scene
    from pathtracer_tpu.scene.fixtures import scene_path

    for name in ("teapot", "animal"):
        scene, settings = load_scene(scene_path(name))
        pools = ray_pools(scene, settings)
        fns = {impl: jax.jit(lambda sc, o, d, a, impl=impl: intersect_scene(
            sc, settings.geom_types, o, d, bvh_impl=impl, active=a,
            interpret=settings.interpret))
            for impl in ("triton", "jnp")}
        for pool_name, (o, d, act) in zip(("primary", "bounce"), pools):
            out, ms = {}, {}
            for impl, fn in fns.items():
                _ready(fn(scene, o, d, act))   # compile
                t0 = time.perf_counter()
                out[impl] = _ready(fn(scene, o, d, act))
                ms[impl] = 1e3 * (time.perf_counter() - t0)
            (t1, _, m1), (t2, _, m2) = out["triton"], out["jnp"]
            t1, t2 = np.asarray(t1), np.asarray(t2)
            m1, m2 = np.asarray(m1), np.asarray(m2)
            live = np.asarray(act)
            hit_agree = float(((t1 > 0) == (t2 > 0))[live].mean())
            both = (t1 > 0) & (t2 > 0) & live
            rel = np.abs(t1 - t2)[both] / t2[both]
            dt_share = float((rel > 1e-5).mean()) if both.any() else 0.0
            mat_share = float((m1 != m2)[both].mean()) if both.any() else 0.0
            log(f"  {name} {pool_name}: {t1.shape[0]} rays, "
                f"{int(live.sum())} active, hits {int((t1 > 0).sum())}/"
                f"{int((t2 > 0).sum())}; hit agreement {hit_agree:.6f}, "
                f"|dt|/t>1e-5 share {dt_share:.2e} (max "
                f"{float(rel.max()) if both.any() else 0.0:.2e}), material "
                f"mismatch share {mat_share:.2e}; intersect kernel "
                f"{ms['triton']:.3f} ms, XLA walk {ms['jnp']:.3f} ms")
            assert hit_agree >= AGREE_MIN_HIT, hit_agree
            assert dt_share <= AGREE_MAX_DT_SHARE, dt_share
            assert mat_share <= AGREE_MAX_MAT_SHARE, mat_share


def phase_parity():
    from tools.golden_parity import compute_parity

    m = compute_parity(spp=1000, chunk=100, png_path=None)
    log(f"  cornell 800x800 1000 spp vs golden: b8 {m['b8_mean']:.5f} "
        f"b16 {m['b16_mean']:.5f} corr {m['corr']:.5f} mean delta "
        f"{m['mean_delta'].round(5).tolist()} ({m['seconds']:.2f} s)")
    # the envelope of tests/test_parity_full.py
    assert m["b8_mean"] < 0.006, m
    assert m["b16_mean"] < 0.004, m
    assert m["corr"] > 0.97, m
    assert m["mean_delta"].max() < 0.004, m


def fit_step_once(scene, settings, mesh):
    """Target at the true albedo, one SGD step from a perturbed one."""
    import jax.numpy as jnp
    from pathtracer_tpu.engine.wavefront import zero_accum
    from pathtracer_tpu.parallel.sharding import (albedo_fit_step,
                                                  render_chunk_sharded,
                                                  replicate, shard_accum)

    scene_r = replicate(scene, mesh)
    target = _ready(render_chunk_sharded(
        scene_r, settings, mesh, shard_accum(zero_accum(settings), mesh),
        jnp.int32(1), 1, 0, False))
    mats = scene_r.materials
    wrong = scene_r._replace(materials=mats._replace(
        color=jnp.clip(mats.color + 0.1, 0.0, 1.0)))
    t0 = time.perf_counter()
    new, loss = _ready(albedo_fit_step(wrong, settings, mesh, target,
                                       jnp.int32(1), lr=0.5, seed=0))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    new, loss = _ready(albedo_fit_step(wrong, settings, mesh, target,
                                       jnp.int32(1), lr=0.5, seed=0))
    return new, float(loss), compile_s, time.perf_counter() - t0


def phase_fit():
    import jax
    import numpy as np
    from pathtracer_tpu import load_scene
    from pathtracer_tpu.parallel.sharding import make_ray_mesh
    from pathtracer_tpu.scene.fixtures import scene_path

    scene, settings = load_scene(scene_path("cornell"))
    new, loss, compile_s, step_s = fit_step_once(
        scene, settings, make_ray_mesh(1))
    moved = float(np.abs(np.asarray(new.materials.color)
                         - np.asarray(scene.materials.color)).max())
    peak = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", -1)
    log(f"  albedo_fit_step cornell 800x800 d8: loss {loss:.6g}, "
        f"first call {compile_s:.2f} s, step {1e3 * step_s:.3f} ms, "
        f"peak device memory {peak / 2**30:.2f} GiB")
    assert np.isfinite(loss) and loss > 0, loss
    assert np.isfinite(np.asarray(new.materials.color)).all()
    assert moved > 0, "albedo did not move"


def phase_memory():
    import jax.numpy as jnp
    from pathtracer_tpu import load_scene
    from pathtracer_tpu.engine.wavefront import render_chunk, zero_accum
    from pathtracer_tpu.scene.fixtures import scene_path

    scene, settings = load_scene(scene_path("animal"))
    compiled = render_chunk.lower(scene, settings, zero_accum(settings),
                                  jnp.int32(1), 1, 0, True).compile()
    mem = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    log("  alien frame memory_analysis: " + ", ".join(
        f"{f} {getattr(mem, f, 'n/a')}" for f in fields))
    text = compiled.as_text()
    found = [k for k in ("__gpu$xla.gpu.triton", "bvh_walk") if k in text]
    log(f"  alien frame HLO names the kernel: {found}")
    assert settings.bvh_impl != "triton" or found, "kernel not in the frame"


def run_four():
    """The hero config over four cards against one card, the sharded fit
    step against one card, and each card's memory."""
    import jax
    import numpy as np
    from pathtracer_tpu import load_scene, render
    from pathtracer_tpu.parallel.sharding import make_ray_mesh, render_sharded
    from pathtracer_tpu.scene.fixtures import scene_path

    devs = jax.devices()
    assert len(devs) >= 4, f"--four needs 4 GPUs, found {len(devs)}"
    mesh4 = make_ray_mesh(4)

    t_phase = time.perf_counter()
    scene, settings = load_scene(scene_path("animal"), overrides={
        "RES": [1200, 1200], "DEPTH": 12})
    spp = 16
    one = lambda: render(scene, settings, iterations=spp, chunk=spp)
    four = lambda: render_sharded(scene, settings, mesh4, iterations=spp,
                                  chunk=spp)
    imgs, secs = {}, {}
    for name, fn in (("one", one), ("four", four)):
        fn()                                   # compile
        t0 = time.perf_counter()
        imgs[name] = fn()
        secs[name] = time.perf_counter() - t0
        check_image(imgs[name], settings.height, settings.width)
    a = image_agreement(imgs["one"], imgs["four"])
    eff = secs["one"] / (4 * secs["four"])
    log(f"  hero alien 1200x1200 d12 {spp} spp: one card "
        f"{1e3 * secs['one'] / spp:.3f} ms/frame, four cards "
        f"{1e3 * secs['four'] / spp:.3f} ms/frame, scaling efficiency "
        f"{eff:.3f}; images {a}")
    assert a["share_gt_1e-3"] <= IMAGE_MAX_DIFF_SHARE, a
    log(f"[four] hero ok ({time.perf_counter() - t_phase:.1f} s)")

    t_phase = time.perf_counter()
    scene, settings = load_scene(scene_path("cornell"))
    res = {n: fit_step_once(scene, settings, make_ray_mesh(n)) for n in (1, 4)}
    c1 = np.asarray(res[1][0].materials.color)
    c4 = np.asarray(res[4][0].materials.color)
    log(f"  albedo_fit_step cornell 800x800 d8: loss one {res[1][1]:.7g} "
        f"four {res[4][1]:.7g}; step one {1e3 * res[1][3]:.3f} ms four "
        f"{1e3 * res[4][3]:.3f} ms; max |albedo diff| "
        f"{float(np.abs(c1 - c4).max()):.3e}")
    assert abs(res[1][1] - res[4][1]) <= 1e-4 * abs(res[1][1]), res
    np.testing.assert_allclose(c4, c1, rtol=1e-4, atol=1e-6)
    log(f"[four] fit ok ({time.perf_counter() - t_phase:.1f} s)")

    for d in devs[:4]:
        st = d.memory_stats() or {}
        log(f"  {d}: peak_bytes_in_use {st.get('peak_bytes_in_use')}, "
            f"bytes_in_use {st.get('bytes_in_use')}")
        assert st.get("peak_bytes_in_use", 0) > 0, d


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its one-card "
                         "comparison")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()

    from pathtracer_tpu.scene.bvh import builder_name
    from pathtracer_tpu.utils.compile_cache import enable_compile_cache
    from pathtracer_tpu.utils.device import (device_record, gpu_identity,
                                             require_gpu)

    devs = require_gpu()
    cache = enable_compile_cache()
    t0 = time.perf_counter()
    ident = gpu_identity()
    log(ident)
    log(f"[identity] {device_record(devs)}; compile cache {cache}; BVH "
        f"builder {builder_name()} ({time.perf_counter() - t0:.2f} s)")

    failed = []
    if args.four:
        try:
            run_four()
        except Exception:
            traceback.print_exc()
            failed.append("four")
    else:
        for name in args.phases.split(","):
            fn = globals()[f"phase_{name}"]
            t0 = time.perf_counter()
            try:
                fn()
                log(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)")
            except Exception:
                traceback.print_exc()
                log(f"[{name}] FAILED ({time.perf_counter() - t0:.1f} s)")
                failed.append(name)
    if failed:
        log(f"failed phases: {failed}")
        return 1
    log(ident)
    print(json.dumps({"ok": True, "device": device_record(devs)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
