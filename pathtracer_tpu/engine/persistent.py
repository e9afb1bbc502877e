"""Persistent wavefront engine: 100% lane occupancy, work ∝ path segments.

The reference keeps its ray pool busy by stream-compacting dead paths away
each bounce (thrust::remove_if, pathtrace.cu:601-613), because retired warps
free SM slots. The masked engine (engine/wavefront.py) instead keeps dead
lanes in place, and they WASTE the bounces it spends processing them: a d8
render runs 8 full-pool bounces even though the mean path length in a closed
Cornell box is ~4.4 and in an open scene ~1.5-2.

This engine removes that waste with the opposite move: instead of packing
live rays together, every dead lane IMMEDIATELY RESPAWNS with the next work
item from a rotating schedule, and the loop runs until every pixel has its
`spp` samples. Total steps ≈ spp × mean_path_length + one drain tail — the
minimum for a fixed-shape pool ("persistent threads" / wavefront scheduling
à la Laine-Karras-Aila). The schedule is a rotation whose per-round
lane->pixel map is a circular shift, so contributions bank with a windowed
roll and the engine needs no scatter (a lane pinned to its pixel stalls the
pool on straggler pixels; a scatter-add per step moves more data).

It works because the schedule is affine: lane i's k-th assignment serves
pixel (i + k·C) mod n with C coprime to n — each round k is a permutation of
all pixels (exact spp accounting), and the lane->pixel map of a WHOLE ROUND
is one circular shift. Contributions are therefore banked per-round in LANE
space (pure elementwise, W in-flight round buffers), and when every lane has
passed round r, that round's buffer flushes into the accumulation image as
accum += roll(buf[r mod W], r·C mod n) — a contiguous rotate, one flush max
per step. Lanes more than W-1 rounds ahead of the slowest lane briefly stall
(the sweep above balances it against banking traffic).

RNG is keyed on (seed, sample, depth, PIXEL) — ops/rng.py decision_state —
so this engine draws the SAME random numbers for the same logical sample as
the masked/sorted engines: images match across engines exactly up to float
accumulation order. jax.random threefry cannot express cheap per-lane keys,
so this engine always uses the fast hash streams.

Termination semantics are IDENTICAL to engine/wavefront.py (same shade()):
emitter hit / miss-black / depth-exhaustion-quirk (SURVEY.md §3.2).
"""
from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import rng
from ..ops.bsdf import shade
from ..ops.camera import generate_camera_rays
from ..ops.intersect import intersect_scene
from ..scene.types import RenderSettings, SceneArrays
from ..utils.vec import Vec3

WINDOW = 4  # in-flight assignment rounds (W buffers of 3x[n] f32): each
# step rewrites W x 3 x [n] banks, traded against lanes stalling more than
# W-1 rounds ahead; not yet re-swept on the GPU.


def pixel_stride(n: int) -> int:
    """Golden-ratio stride coprime with n: consecutive assignments of a lane
    land far apart in the image, so each lane samples the image uniformly."""
    c = max(1, int(n * 0.6180339887498949)) | 1
    while math.gcd(c, n) != 1:
        c += 2
    return c % n


class LaneState(NamedTuple):
    """Per-lane persistent state + windowed accumulation."""

    origin: Vec3
    direction: Vec3
    color: Vec3                     # running throughput of the current sample
    remaining_bounces: jnp.ndarray  # i32: >0 live, <=0 done
    assign: jnp.ndarray             # i32: 1-based assignment (= sample) index
    pixel: jnp.ndarray              # i32: LOCAL pixel of the current sample
    round_buf: jnp.ndarray          # [W, 3, n] f32 lane-space round banks
    flushed: jnp.ndarray            # i32 scalar: rounds <= flushed are banked
    accum: Vec3                     # running SUM image (reference dev_image)


def fresh_lanes(settings: RenderSettings, n: int | None = None,
                accum: Vec3 | None = None, start_spp: int = 0) -> LaneState:
    """All lanes parked at assignment `start_spp` (they respawn on the first
    step). A drained chunk boundary IS a checkpoint: the while_loop only
    stops when every lane has finished and flushed its target, so resuming =
    fresh lanes at (accum, start_spp) — the pixel schedule and RNG are pure
    functions of the assignment index, making resume bit-exact (tested)."""
    if n is None:
        n = settings.pixel_count
    # distinct buffers per field: the chunk jit donates the whole LaneState,
    # and donation rejects aliased buffers
    return LaneState(
        origin=Vec3.zeros((n,)), direction=Vec3.zeros((n,)),
        color=Vec3.zeros((n,)),
        remaining_bounces=jnp.zeros((n,), jnp.int32),
        assign=jnp.full((n,), start_spp, jnp.int32),
        pixel=jnp.arange(n, dtype=jnp.int32),
        round_buf=jnp.zeros((WINDOW, 3, n), jnp.float32),
        flushed=jnp.int32(start_spp),
        accum=Vec3.zeros((n,)) if accum is None else accum,
    )


def _flush_round(state: LaneState, r: jnp.ndarray, stride: int) -> LaneState:
    """Bank round r: accum += roll(round_buf[r % W], r*C mod n); zero slot."""
    n = state.accum.x.shape[0]
    w = r % WINDOW
    buf = jax.lax.dynamic_index_in_dim(state.round_buf, w, 0,
                                       keepdims=False)       # [3, n]
    # int32 product wraps identically to the per-lane pixel computation in
    # _step, and (i + w) % n == (i + w % n) % n keeps roll and schedule
    # congruent mod n
    shift = (r * jnp.int32(stride)) % jnp.int32(n)
    rolled = jnp.roll(buf, shift, axis=1)
    accum = Vec3(state.accum.x + rolled[0], state.accum.y + rolled[1],
                 state.accum.z + rolled[2])
    round_buf = jax.lax.dynamic_update_index_in_dim(
        state.round_buf, jnp.zeros((3, n), jnp.float32), w, 0)
    return state._replace(round_buf=round_buf, flushed=r, accum=accum)


def _step(scene: SceneArrays, settings: RenderSettings, seed: int,
          state: LaneState, spp_target: jnp.ndarray, stride: int,
          pixel_offset) -> LaneState:
    """One persistent step: respawn -> intersect -> shade -> bank -> flush."""
    n = state.assign.shape[0]
    lane = jnp.arange(n, dtype=jnp.int32)

    # --- respawn dead lanes that still owe assignments (window-gated) --------
    need = jnp.logical_and(
        state.remaining_bounces <= 0,
        jnp.logical_and(state.assign < spp_target,
                        state.assign <= state.flushed + (WINDOW - 1)))
    assign = jnp.where(need, state.assign + 1, state.assign)
    # round k is the permutation i -> (i + k*C) mod n. Reduce the product mod
    # n BEFORE adding the lane index: the raw int32 product assign*stride
    # wraps near 2^31 at high spp (first bad round ~5428 at 800x800), and the
    # re-wrapped sum would land lanes on pixels incongruent with
    # _flush_round's shift = (r*C) mod n — silently biasing the image. With
    # the reduction both operands are < n, so the sum never overflows and
    # stays congruent with the flush for any spp.
    pixel = jnp.where(
        need,
        (lane + (assign * jnp.int32(stride)) % jnp.int32(n)) % jnp.int32(n),
        state.pixel)
    pixel_g = settings.pixel_map()(pixel + pixel_offset)

    jitter = (rng.fast_normals_perlane(
        rng.decision_state(seed, assign, -1, pixel_g), 2)
        if settings.jitter else None)
    dof_u = (rng.fast_uniforms_perlane(
        rng.decision_state(seed, assign, -2, pixel_g), 2)
        if settings.dof else None)
    o, d = generate_camera_rays(scene.camera, settings.width, settings.height,
                                jitter, dof_u, n=n, pixel_idx=pixel_g)

    one = jnp.ones((n,), jnp.float32)
    origin = Vec3.where(need, o, state.origin)
    direction = Vec3.where(need, d, state.direction)
    color = Vec3.where(need, Vec3(one, one, one), state.color)
    rb = jnp.where(need, settings.trace_depth, state.remaining_bounces)

    # --- one bounce for every live lane --------------------------------------
    t, normal, mat_id = intersect_scene(
        scene, settings.geom_types, origin, direction,
        bvh_impl=settings.bvh_impl, active=rb > 0,
        interpret=settings.interpret)
    depth = settings.trace_depth - rb                     # per-lane depth
    u = rng.fast_uniforms_perlane(
        rng.decision_state(seed, assign, depth, pixel_g),
        5 if settings.rr_start else 4)
    origin, direction, color, rb = shade(
        origin, direction, color, rb, t, normal, mat_id, scene.materials, u,
        any_glossy=settings.any_glossy,
        any_refractive=settings.any_refractive,
        depth_quirk=settings.depth_quirk,
        rr_depth=depth, rr_start=settings.rr_start)

    # --- bank finished samples into their round's lane-space buffer ----------
    done = rb == 0
    round_buf = state.round_buf
    for w in range(WINDOW):
        m = jnp.logical_and(done, assign % WINDOW == w)
        contrib = jnp.stack([jnp.where(m, color.x, 0.0),
                             jnp.where(m, color.y, 0.0),
                             jnp.where(m, color.z, 0.0)])
        round_buf = round_buf.at[w].add(contrib)
    rb = jnp.where(done, -1, rb)

    state = LaneState(origin, direction, color, rb, assign, pixel,
                      round_buf, state.flushed, state.accum)

    # --- flush at most one completed round (min rises by <= 1 per step) ------
    completed = assign - (rb > 0)          # rounds fully contributed per lane
    min_done = jnp.min(completed)
    return jax.lax.cond(
        min_done > state.flushed,
        lambda s: _flush_round(s, state.flushed + 1, stride),
        lambda s: s, state)


@partial(jax.jit, static_argnames=("settings", "seed", "stride",
                                   "pixel_offset"),
         donate_argnames=("state",))
def render_persistent_chunk(scene: SceneArrays, settings: RenderSettings,
                            state: LaneState, spp_target: jnp.ndarray,
                            seed: int = 0, stride: int | None = None,
                            pixel_offset: int = 0) -> LaneState:
    """Run until every pixel has `spp_target` accumulated samples (flushed).

    Carry the returned state into the next chunk (with a larger spp_target)
    to keep lanes rolling across chunk boundaries — the drain tail happens
    only once, at the very end of the render.
    """
    if stride is None:
        stride = pixel_stride(state.assign.shape[0])

    def cond(s):
        return jnp.logical_or(
            jnp.any(jnp.logical_or(s.remaining_bounces > 0,
                                   s.assign < spp_target)),
            s.flushed < spp_target)

    def body(s):
        return _step(scene, settings, seed, s, spp_target, stride,
                     pixel_offset)

    return jax.lax.while_loop(cond, body, state)


def render_persistent(scene: SceneArrays, settings: RenderSettings,
                      iterations: int | None = None, seed: int = 0,
                      chunk: int = 64, progress=None,
                      accum: Vec3 | None = None,
                      start_iteration: int = 0) -> jnp.ndarray:
    """Full progressive render with the persistent engine; [H,W,3] average.

    `accum`/`start_iteration` resume from a drained checkpoint (same
    contract as engine/wavefront.render; see fresh_lanes)."""
    spp = settings.iterations if iterations is None else iterations
    state = fresh_lanes(settings, accum=accum, start_spp=start_iteration)
    stride = pixel_stride(settings.pixel_count)
    done = start_iteration
    total = start_iteration + spp
    while done < total:
        done = min(done + chunk, total)
        state = render_persistent_chunk(scene, settings, state,
                                        jnp.int32(done), seed, stride)
        if progress is not None:
            progress(done, state.accum)
    from .wavefront import lanes_to_image
    avg = state.accum * (1.0 / jnp.float32(total))
    return lanes_to_image(avg, settings)
