"""Per-stage performance instrumentation — the EVALUATION-flag equivalent.

The reference wraps each stage in cudaEvent timers and prints averaged stats
every 100 iterations (pathtrace.cu:110-120,629-673, printPerformanceStats).
Under XLA the stages of a frame are fused into one program, so per-stage
wall-time isn't observable in situ; this harness times each stage as its own
jitted program on a representative pool (the reference's numbers are also
per-kernel sums), plus the true end-to-end frame time for the fused loop.

Usage: python tools/perfstats.py <scene.json>
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict

import jax
import jax.numpy as jnp

from ..engine.wavefront import (bounce_step, generate_paths, render_chunk,
                                zero_accum)
from ..ops import rng
from ..ops.bsdf import shade
from ..ops.intersect import intersect_scene
from ..scene.types import RenderSettings, SceneArrays
from ..utils.vec import Vec3


@dataclass
class StageStats:
    """Per-stage averaged milliseconds (printPerformanceStats analogue)."""

    raygen_ms: float
    intersect_ms: float
    shade_ms: float
    gather_ms: float
    frame_ms: float          # true fused end-to-end frame (trace_depth bounces)
    trace_depth: int

    def table(self) -> str:
        per_bounce = [
            ("Ray generation", self.raygen_ms, 1),
            ("Intersection", self.intersect_ms, self.trace_depth),
            ("Shading", self.shade_ms, self.trace_depth),
            ("Gather", self.gather_ms, self.trace_depth),
        ]
        total_est = sum(ms * mult for _, ms, mult in per_bounce)
        lines = ["=== Performance Statistics (per-stage, isolated jits) ===",
                 f"{'Stage':<16}{'ms/call':>10}{'calls':>7}{'ms/frame':>10}"
                 f"{'%':>7}"]
        for name, ms, mult in per_bounce:
            lines.append(f"{name:<16}{ms:>10.3f}{mult:>7}{ms * mult:>10.3f}"
                         f"{100 * ms * mult / total_est:>6.1f}%")
        lines.append(f"{'SUM (isolated)':<16}{'':>10}{'':>7}{total_est:>10.3f}")
        lines.append(f"{'FUSED frame':<16}{'':>10}{'':>7}{self.frame_ms:>10.3f}"
                     f"   (XLA fusion gain: "
                     f"{total_est / max(self.frame_ms, 1e-9):.2f}x)")
        return "\n".join(lines)


def _time(fn, iters=20) -> float:
    """Average ms of fn(k) for k = 1..iters, after a warm-up call fn(0)."""
    out = fn(0)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for k in range(1, iters + 1):
        out = fn(k)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def measure_stages(scene: SceneArrays, settings: RenderSettings,
                   seed: int = 0) -> StageStats:
    """Time raygen / intersect / shade / gather in isolation + fused frame."""

    @jax.jit
    def f_raygen(scene, it):
        irng = rng.IterationRng(settings.fast_rng, seed, it)
        return generate_paths(scene, settings, irng)

    state = f_raygen(scene, jnp.int32(1))

    @jax.jit
    def f_isect(scene, state, eps):
        origin = Vec3(state.origin.x + eps, state.origin.y, state.origin.z)
        return intersect_scene(scene, settings.geom_types, origin,
                               state.direction, bvh_impl=settings.bvh_impl,
                               interpret=settings.interpret)

    t, normal, mat = f_isect(scene, state, jnp.float32(0))

    @jax.jit
    def f_shade(scene, state, t, normal, mat, it):
        irng = rng.IterationRng(settings.fast_rng, seed, it)
        u = irng.uniforms(jnp.int32(0), state.pixel, 4)
        return shade(state.origin, state.direction, state.color,
                     state.remaining_bounces, t, normal, mat,
                     scene.materials, u, any_glossy=settings.any_glossy,
                     any_refractive=settings.any_refractive,
                     depth_quirk=settings.depth_quirk)

    shaded = f_shade(scene, state, t, normal, mat, jnp.int32(1))

    @jax.jit
    def f_gather(color_x, color_y, color_z, rb, image, eps):
        done = rb == 0
        return Vec3(image.x + jnp.where(done, color_x + eps, 0.0),
                    image.y + jnp.where(done, color_y, 0.0),
                    image.z + jnp.where(done, color_z, 0.0))

    img = zero_accum(settings)
    _, _, color, rb = shaded

    frame_ms = _time(
        lambda k: render_chunk(scene, settings, zero_accum(settings),
                               jnp.int32(k + 1), 1, seed, True), iters=30)

    return StageStats(
        raygen_ms=_time(lambda k: f_raygen(scene, jnp.int32(k + 2))),
        intersect_ms=_time(
            lambda k: f_isect(scene, state, jnp.float32(k) * 1e-6)),
        shade_ms=_time(
            lambda k: f_shade(scene, state, t, normal, mat, jnp.int32(k + 3))),
        gather_ms=_time(
            lambda k: f_gather(color.x, color.y, color.z, rb, img,
                               jnp.float32(k) * 1e-6)),
        frame_ms=frame_ms,
        trace_depth=settings.trace_depth,
    )


def ray_survival_report(scene: SceneArrays, settings: RenderSettings,
                        iteration: int = 10, seed: int = 0) -> str:
    """PRINT_RAY_COUNT equivalent (pathtrace.cu:746-750,877-881)."""
    from ..engine.wavefront import ray_survival

    counts = ray_survival(scene, settings, jnp.int32(iteration), seed=seed)
    counts = [int(c) for c in counts]
    lines = [f"[Iter {iteration}] Initial rays: {counts[0]}"]
    for d, c in enumerate(counts[1:], start=1):
        lines.append(f"[Iter {iteration}] After bounce {d}: {c} rays remaining")
    return "\n".join(lines)
