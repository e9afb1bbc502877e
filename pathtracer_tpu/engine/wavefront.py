"""Wavefront render engine: the bounce loop.

The reference streams a shrinking ray pool through per-stage kernel launches
with host-side loop control (pathtrace, src/pathtrace.cu:679-914). The
shape used here is a FIXED-SIZE, mask-carrying wavefront inside a
single jit-compiled program: one lane per pixel, `remaining_bounces` encodes
liveness exactly as the reference does (>0 live, ==0 done-not-gathered,
-1 gathered), and the bounce loop is a lax.scan (differentiable) or
lax.while_loop (forward-only, early-exits when every path has terminated —
the analogue of the reference's `num_paths == 0` exit at pathtrace.cu:882-889).

Three pool-processing modes map the reference's feature flags:

  masked (default)       Lane index == pixel index; dead lanes are select-noops.
                         The per-bounce image gather (gatherImage,
                         pathtrace.cu:574-589) is a pure elementwise select-add.
                         The fastest Cornell mode on the H100 (PERF.md).

  compact (STREAM_COMPACT equivalent, settings.compact + early_exit)
                         Tile-granular work skipping: the pool is processed in
                         static tiles and a tile whose lanes are ALL dead is
                         skipped via lax.cond — zero intersect/shade/RNG work.
                         Opt-in ablation mode, not yet measured on the GPU.
                         The persistent-wavefront engine (engine/persistent.py)
                         is the other answer to dead lanes: it respawns them
                         with the next sample.

  sorted (COALESCED equivalent, settings.sort_materials + early_exit)
                         Per bounce: full-pool intersect, stable multi-operand
                         sort by material key (kernSetKeys + sort_by_key,
                         pathtrace.cu:592-599,825-841), then shade. Lanes
                         carry their pixel index through the bounce loop and
                         ONE deferred segmented sort restores pixel order
                         after it (bounce_step_sorted below). All BSDF
                         branches are computed and selected anyway, so the
                         mode costs more than masked. Kept as the parity mode
                         for the flag; masked remains the production default,
                         as unsorted does in the reference (README.md:161-165).

Accumulation contract matches the reference: the image is a running SUM over
iterations; display/save divides by the iteration count (pathtrace.cu:88-90,
main.cpp:395-417).

All per-ray state is component-SoA (Vec3 of [N]) — see utils/vec.py for why.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..ops import rng
from ..ops.bsdf import shade
from ..ops.camera import generate_camera_rays
from ..ops.intersect import intersect_scene
from ..ops.scan import sort_by_key_multisort, sort_by_key_segmented
from ..scene.types import RenderSettings, SceneArrays
from ..utils.vec import Vec3


class PathState(NamedTuple):
    origin: Vec3                    # [N] x3
    direction: Vec3                 # [N] x3
    color: Vec3                     # [N] x3 running throughput
    remaining_bounces: jnp.ndarray  # [N] i32
    pixel: jnp.ndarray              # [N] i32 local pixel index (PathSegment::
    #                                 pixelIndex, sceneStructs.h:104; identity
    #                                 until a sort permutes lanes)


def generate_paths(scene: SceneArrays, settings: RenderSettings,
                   irng: rng.IterationRng, n: int | None = None,
                   pixel_offset=0) -> PathState:
    """Camera raygen -> fresh path pool (generateRayFromCamera,
    pathtrace.cu:260-322). `n`/`pixel_offset` support sharded local blocks."""
    if n is None:
        n = settings.pixel_count
    with jax.named_scope("pt_raygen"):
        lanes = jnp.arange(n, dtype=jnp.int32)
        jitter = irng.normals(-1, lanes, 2) if settings.jitter else None
        dof_u = irng.uniforms(-2, lanes, 2) if settings.dof else None
        pixel_ids = settings.pixel_map()(lanes + pixel_offset)
        origin, direction = generate_camera_rays(
            scene.camera, settings.width, settings.height, jitter, dof_u,
            n=n, pixel_idx=pixel_ids)
    one = jnp.ones((n,), dtype=jnp.float32)
    return PathState(
        origin=origin,
        direction=direction,
        color=Vec3(one, one, one),
        remaining_bounces=jnp.full((n,), settings.trace_depth, dtype=jnp.int32),
        pixel=jnp.arange(n, dtype=jnp.int32),
    )


def bounce_step(scene: SceneArrays, settings: RenderSettings,
                irng: rng.IterationRng, depth: jnp.ndarray,
                state: PathState, image: Vec3) -> Tuple[PathState, Vec3]:
    """One bounce, masked mode: intersect -> shade -> gather
    (pathtrace.cu:752-894 body). Lane == pixel; elementwise gather.

    Stages carry jax.named_scope markers ("pt_intersect"/"pt_shade"/
    "pt_gather"): XLA propagates them into device-op metadata so an xplane
    profile of the FUSED frame can attribute time per stage
    (tools/xplane_stats.py — the EVALUATION analogue measured in situ)."""
    n = state.origin.x.shape[0]
    with jax.named_scope("pt_intersect"):
        t, normal, mat_id = intersect_scene(
            scene, settings.geom_types, state.origin, state.direction,
            bvh_impl=settings.bvh_impl, active=state.remaining_bounces > 0,
            interpret=settings.interpret)

    with jax.named_scope("pt_shade"):
        u = irng.uniforms(depth, state.pixel, 5 if settings.rr_start else 4)
        origin, direction, color, rb = shade(
            state.origin, state.direction, state.color,
            state.remaining_bounces,
            t, normal, mat_id, scene.materials, u,
            any_glossy=settings.any_glossy,
            any_refractive=settings.any_refractive,
            depth_quirk=settings.depth_quirk,
            rr_depth=depth, rr_start=settings.rr_start)

    # gatherImage: add lanes whose remaining_bounces just reached 0, then mark
    # them gathered (-1) so they are skipped and never double-added
    # (pathtrace.cu:574-589 with the !STREAM_COMPACT marker semantics).
    with jax.named_scope("pt_gather"):
        newly_done = rb == 0
        zero = Vec3.zeros((n,))
        image = image + Vec3.where(newly_done, color, zero)
        rb = jnp.where(newly_done, -1, rb)

    return PathState(origin, direction, color, rb, state.pixel), image


def bounce_step_sorted(scene: SceneArrays, settings: RenderSettings,
                       irng: rng.IterationRng, depth: jnp.ndarray,
                       state: PathState, image: Vec3
                       ) -> Tuple[PathState, Vec3]:
    """One bounce, material-sorted mode (COALESCED, pathtrace.cu:825-841).

    Stages over the full pool: intersect -> set keys -> stable sort by key
    (state AND intersection ride the sort network together, like
    kernGatherArrays' double-buffer gather) -> shade. Lanes STAY permuted
    across bounces — pixel ids ride the sorts, and the gather happens ONCE
    after the bounce loop (render_iteration): terminated lanes' colors are
    frozen (shade passes rb <= 0 lanes through unchanged), so deferring the
    image add to a single end-of-iteration unsort is exact and halves the
    sort traffic of a per-bounce unsort.
    """
    t, normal, mat_id = intersect_scene(
        scene, settings.geom_types, state.origin, state.direction,
        bvh_impl=settings.bvh_impl, interpret=settings.interpret)

    # kernSetKeys (pathtrace.cu:592-599): the key is the intersection's
    # materialId; misses keep the memset default 0 (pathtrace.cu:755).
    # The sort is SEGMENTED over columns of a (rows, 128) view when the pool
    # divides 128 (sort_by_key_segmented) — grouping scope is a locality
    # knob, not a semantics one, since shade is elementwise and the
    # deferred pixel unsort inverts any permutation.
    keys = jnp.where(t > 0.0, mat_id, 0)
    payload = (state, t, normal, mat_id)
    seg_ok = state.pixel.shape[0] % 128 == 0
    sorter = sort_by_key_segmented if seg_ok else sort_by_key_multisort
    _, (state, t, normal, mat_id) = sorter(keys, payload)

    u = irng.uniforms(depth, state.pixel, 5 if settings.rr_start else 4)
    origin, direction, color, rb = shade(
        state.origin, state.direction, state.color, state.remaining_bounces,
        t, normal, mat_id, scene.materials, u,
        any_glossy=settings.any_glossy,
        any_refractive=settings.any_refractive,
        depth_quirk=settings.depth_quirk,
        rr_depth=depth, rr_start=settings.rr_start)

    # mark newly-terminated lanes gathered; their colors are now frozen and
    # collected by the deferred end-of-iteration gather (render_iteration)
    rb = jnp.where(rb == 0, -1, rb)
    return PathState(origin, direction, color, rb, state.pixel), image


def bounce_step_tiled(scene: SceneArrays, settings: RenderSettings,
                      irng: rng.IterationRng, depth: jnp.ndarray,
                      state: PathState, image: Vec3, tile: int
                      ) -> Tuple[PathState, Vec3]:
    """One bounce, compact mode: per-tile work skipping (STREAM_COMPACT's
    compute win, zero data movement — see module docstring).

    The pool is reshaped [n] -> [n_tiles, tile] and walked with lax.scan over
    the tile axis (windowed xs/ys, not fori_loop + dynamic_update_slice with
    its per-tile pool-wide updates). A tile whose lanes are all dead skips
    intersect/shade/RNG via lax.cond.
    Lane == pixel is preserved, so image updates stay elementwise.
    """
    n = state.origin.x.shape[0]
    assert n % tile == 0, f"pool {n} not divisible by tile {tile}"
    n_tiles = n // tile

    tiled = jax.tree_util.tree_map(
        lambda a: a.reshape(n_tiles, tile), (state, image))

    def body(k, xs):
        s, img = xs

        def process(operands):
            s, img = operands
            t, normal, mat_id = intersect_scene(
                scene, settings.geom_types, s.origin, s.direction,
                bvh_impl=settings.bvh_impl, interpret=settings.interpret)
            u = irng.uniforms(depth, s.pixel, 5 if settings.rr_start else 4,
                              salt=k)
            origin, direction, color, rb = shade(
                s.origin, s.direction, s.color, s.remaining_bounces,
                t, normal, mat_id, scene.materials, u,
                any_glossy=settings.any_glossy,
                any_refractive=settings.any_refractive,
                depth_quirk=settings.depth_quirk,
                rr_depth=depth, rr_start=settings.rr_start)
            newly_done = rb == 0
            img = img + Vec3.where(newly_done, color, Vec3.zeros((tile,)))
            rb = jnp.where(newly_done, -1, rb)
            return PathState(origin, direction, color, rb, s.pixel), img

        live = jnp.any(s.remaining_bounces > 0)
        s, img = jax.lax.cond(live, process, lambda o: o, (s, img))
        return k + 1, (s, img)

    _, (state_t, image_t) = jax.lax.scan(body, jnp.int32(0), tiled)
    state, image = jax.tree_util.tree_map(
        lambda a: a.reshape(n), (state_t, image_t))
    return state, image


def _dispatch_bounce(scene, settings, irng, depth, state, image,
                     early_exit: bool):
    """Pick the bounce implementation for the configured mode.

    The sorted/tiled modes are forward-only perf/parity modes; the
    differentiable path (early_exit=False, used under jax.grad) always takes
    the fused masked step.
    """
    if early_exit and settings.sort_materials:
        return bounce_step_sorted(scene, settings, irng, depth, state,
                                  image)
    if early_exit and settings.compact:
        tile = min(settings.compact_tile, image.x.shape[0])
        if image.x.shape[0] % tile == 0 and image.x.shape[0] > tile:
            return bounce_step_tiled(scene, settings, irng, depth, state,
                                     image, tile)
        import warnings
        warnings.warn(
            f"compact=True but pool size {image.x.shape[0]} is not divisible "
            f"by compact_tile={settings.compact_tile} (or not larger than "
            "it); falling back to masked mode. Pick a dividing compact_tile "
            "to get tile skipping.", stacklevel=2)
    return bounce_step(scene, settings, irng, depth, state, image)


def render_iteration(scene: SceneArrays, settings: RenderSettings,
                     accum: Vec3, iteration: jnp.ndarray,
                     seed: int = 0, early_exit: bool = False,
                     pixel_offset=0, key_salt=None) -> Vec3:
    """One progressive-render iteration: raygen + full bounce loop.

    Args:
      accum: Vec3 of [N] running sum image (donated by callers). N may be a
        local shard of the pixel pool (then pass pixel_offset).
      iteration: scalar int iteration counter (seeds the RNG stream).
      early_exit: use a while_loop that stops when all paths are terminated
        (forward-only; not reverse-differentiable). When False, a lax.scan over
        trace_depth bounces is used, which jax.grad can differentiate.
      pixel_offset: global pixel index of accum's first lane (sharded callers).
      key_salt: extra value folded into the RNG key (e.g. shard index, so each
        shard draws an independent stream).

    Returns the updated accumulation image.
    """
    irng = rng.IterationRng(settings.fast_rng, seed, iteration,
                            pixel_offset=pixel_offset, key_salt=key_salt,
                            pixel_map=settings.pixel_map())
    n = accum.x.shape[0]
    state = generate_paths(scene, settings, irng, n=n,
                           pixel_offset=pixel_offset)

    if early_exit:
        def cond(carry):
            depth, state, _ = carry
            return jnp.logical_and(depth < settings.trace_depth,
                                   jnp.any(state.remaining_bounces > 0))

        def body(carry):
            depth, state, image = carry
            state, image = _dispatch_bounce(scene, settings, irng, depth,
                                            state, image, early_exit=True)
            return depth + 1, state, image

        _, state, accum = jax.lax.while_loop(
            cond, body, (jnp.int32(0), state, accum))
        if settings.sort_materials:
            # deferred COALESCED gather: one unsort restores lane == pixel,
            # then terminated (gathered-marked) lanes add elementwise.
            # Segmented unsort is exact: lanes never leave their column, and
            # within a column the original pixel order was ascending.
            unsorter = (sort_by_key_segmented
                        if n % 128 == 0 else sort_by_key_multisort)
            _, (color, rb) = unsorter(
                state.pixel, (state.color, state.remaining_bounces))
            accum = accum + Vec3.where(rb == -1, color,
                                       Vec3.zeros((n,)))
        return accum

    def scan_body(carry, depth):
        state, image = carry
        state, image = bounce_step(scene, settings, irng, depth,
                                   state, image)
        return (state, image), None

    (_, accum), _ = jax.lax.scan(
        scan_body, (state, accum),
        jnp.arange(settings.trace_depth, dtype=jnp.int32))
    return accum


def ray_survival(scene: SceneArrays, settings: RenderSettings,
                 iteration: jnp.ndarray, seed: int = 0,
                 n: int | None = None, pixel_offset=0,
                 key_salt=None) -> jnp.ndarray:
    """Live-ray count per bounce depth for one iteration — the
    PRINT_RAY_COUNT instrumentation (pathtrace.cu:42,746-750,877-881) that
    produced the reference's ray-survival table (README.md:112-116).

    `n`/`pixel_offset`/`key_salt` scope the count to a shard-local pixel
    block (parallel/sharding.shard_work_counts uses this as the per-shard
    load-balance probe).

    Returns [trace_depth + 1] i32: counts BEFORE each bounce (index 0 =
    primary rays) and after the last.
    """
    if n is None:
        n = settings.pixel_count
    irng = rng.IterationRng(settings.fast_rng, seed, iteration,
                            pixel_offset=pixel_offset, key_salt=key_salt,
                            pixel_map=settings.pixel_map())
    state = generate_paths(scene, settings, irng, n=n,
                           pixel_offset=pixel_offset)
    image = Vec3.zeros((n,))

    def body(carry, depth):
        state, image = carry
        count = jnp.sum((state.remaining_bounces > 0).astype(jnp.int32))
        state, image = bounce_step(scene, settings, irng, depth,
                                   state, image)
        return (state, image), count

    (state, _), counts = jax.lax.scan(
        body, (state, image), jnp.arange(settings.trace_depth, dtype=jnp.int32))
    final = jnp.sum((state.remaining_bounces > 0).astype(jnp.int32))
    return jnp.concatenate([counts, final[None]])


@partial(jax.jit, static_argnames=("settings", "n_iters", "seed", "early_exit"),
         donate_argnames=("accum",))
def render_chunk(scene: SceneArrays, settings: RenderSettings,
                 accum: Vec3, start_iteration: jnp.ndarray,
                 n_iters: int, seed: int = 0,
                 early_exit: bool = True) -> Vec3:
    """Run `n_iters` progressive iterations inside one compiled program.

    Batching iterations into one jit amortizes dispatch overhead — the
    analogue of the reference's per-frame pathtrace() calls from runCuda
    (main.cpp:454-472) without a host round-trip per frame.
    """
    def body(accum, k):
        it = start_iteration + k
        accum = render_iteration(scene, settings, accum, it, seed=seed,
                                 early_exit=early_exit)
        return accum, None

    accum, _ = jax.lax.scan(body, accum, jnp.arange(n_iters, dtype=jnp.int32))
    return accum


def zero_accum(settings: RenderSettings) -> Vec3:
    return Vec3.zeros((settings.pixel_count,))


def render(scene: SceneArrays, settings: RenderSettings,
           iterations: int | None = None, seed: int = 0,
           chunk: int = 16, early_exit: bool = True,
           accum: Vec3 | None = None,
           start_iteration: int = 0,
           progress=None) -> jnp.ndarray:
    """Full progressive render; returns the AVERAGED image [H,W,3].

    The running-sum accumulation restarts/resumes exactly like the reference's
    dev_image (progressive accumulation; restartable from a checkpoint of
    (accum, iteration) — SURVEY.md §5 checkpoint/resume; see utils/checkpoint).
    """
    n_total = settings.iterations if iterations is None else iterations
    if accum is None:
        accum = zero_accum(settings)
    done = start_iteration
    while done < start_iteration + n_total:
        this = min(chunk, start_iteration + n_total - done)
        accum = render_chunk(scene, settings, accum,
                             jnp.int32(done + 1),  # runCuda uses ++iteration
                             this, seed, early_exit)
        done += this
        if progress is not None:
            progress(done, accum)
    avg = accum * (1.0 / jnp.float32(start_iteration + n_total))
    return lanes_to_image(avg, settings)


def lanes_to_image(avg: Vec3, settings: RenderSettings):
    """Lane-space Vec3 -> [H,W,3] image (undoes tile-major lane order)."""
    import numpy as np

    arr = np.asarray(avg.to_array())
    if settings.tile is None and not settings.shard_interleave:
        return arr.reshape(settings.height, settings.width, 3)
    pm = np.asarray(settings.pixel_map()(
        np.arange(settings.pixel_count, dtype=np.int64)))
    out = np.empty_like(arr)
    out[pm] = arr
    return out.reshape(settings.height, settings.width, 3)
