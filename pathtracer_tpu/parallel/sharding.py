"""Multi-device data parallelism over the ray pool.

Mapping of the workload's one big axis (SURVEY.md §2.6): pixels/rays are
sharded across devices on a 1-D mesh via shard_map; the scene + BVH are
replicated in every device's memory (broadcast once at scene upload); tracing
does ZERO inter-device communication (a ray's pixel never leaves its shard).
The only collectives are:
  - psum of parameter gradients in the differentiable path (an all-reduce
    that XLA hands to NCCL on GPUs),
  - the final image assembly, which is just the natural output sharding
    (all_gather only when the host fetches the image).

The reference has no distributed anything (single GPU, SURVEY.md §2.6); this
module is the from-scratch scaling design the north star requires.
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.wavefront import ray_survival, render_iteration, zero_accum
from ..scene.types import RenderSettings, SceneArrays
from ..utils.vec import Vec3

RAY_AXIS = "rays"


def make_ray_mesh(n_devices: Optional[int] = None,
                  devices=None) -> Mesh:
    """1-D device mesh over the ray-pool axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (RAY_AXIS,))


def shard_accum(accum: Vec3, mesh: Mesh) -> Vec3:
    """Place an accumulation image with its pixel axis sharded over the mesh."""
    sh = NamedSharding(mesh, P(RAY_AXIS))
    return Vec3(*(jax.device_put(c, sh) for c in accum))


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (scene/BVH) to every chip — the analogue of
    pathtraceInit's scene upload (pathtrace.cu:143-233), broadcast once."""
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)



def _interleaved(settings: RenderSettings, n_shards: int) -> RenderSettings:
    """Settings with the round-robin shard interleave applied (see
    RenderSettings.shard_interleave): every sharded entry point routes
    through this so lane semantics agree across render / fit / counts."""
    import dataclasses
    if n_shards <= 1:
        return dataclasses.replace(settings, shard_interleave=None)
    return dataclasses.replace(settings, shard_interleave=n_shards)

def render_chunk_sharded(scene: SceneArrays, settings: RenderSettings,
                         mesh: Mesh, accum: Vec3,
                         start_iteration: jnp.ndarray, n_iters: int,
                         seed: int = 0, early_exit: bool = True) -> Vec3:
    """`n_iters` progressive iterations with the ray pool sharded over `mesh`.

    Each shard renders its own pixel block with an independent RNG stream;
    no cross-device traffic inside the loop. The compiled program is built
    once per (settings, mesh, n_iters, seed, early_exit) and reused.
    """
    run = _chunk_program(settings, mesh, n_iters, seed, early_exit)
    return run(scene, accum, jnp.asarray(start_iteration, jnp.int32))


@lru_cache(maxsize=None)
def _chunk_program(settings: RenderSettings, mesh: Mesh, n_iters: int,
                   seed: int, early_exit: bool):
    n_shards = mesh.shape[RAY_AXIS]
    n_total = settings.pixel_count
    assert n_total % n_shards == 0, (
        f"pixel count {n_total} not divisible by {n_shards} shards")
    n_local = n_total // n_shards
    settings = _interleaved(settings, n_shards)

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P(RAY_AXIS), P()),
             out_specs=P(RAY_AXIS), check_vma=False)
    def run(scene, accum, start_iteration):
        shard = jax.lax.axis_index(RAY_AXIS)
        offset = shard * n_local

        def body(a, k):
            it = start_iteration + k
            a = render_iteration(scene, settings, a, it, seed=seed,
                                 early_exit=early_exit, pixel_offset=offset,
                                 key_salt=shard)
            return a, None

        accum, _ = jax.lax.scan(body, accum,
                                jnp.arange(n_iters, dtype=jnp.int32))
        return accum

    return run


def render_sharded(scene: SceneArrays, settings: RenderSettings,
                   mesh: Optional[Mesh] = None,
                   iterations: Optional[int] = None, seed: int = 0,
                   chunk: int = 16, early_exit: bool = True) -> jnp.ndarray:
    """Full progressive render sharded over a mesh; returns [H,W,3] average."""
    if mesh is None:
        mesh = make_ray_mesh()
    n_total = settings.iterations if iterations is None else iterations
    settings = _interleaved(settings, mesh.shape[RAY_AXIS])
    scene = replicate(scene, mesh)
    accum = shard_accum(zero_accum(settings), mesh)
    done = 0
    while done < n_total:
        this = min(chunk, n_total - done)
        accum = render_chunk_sharded(scene, settings, mesh, accum,
                                     jnp.int32(done + 1), this, seed,
                                     early_exit)
        done += this
    from ..engine.wavefront import lanes_to_image
    avg = accum * (1.0 / jnp.float32(n_total))
    return lanes_to_image(avg, settings)


def render_persistent_sharded(scene: SceneArrays, settings: RenderSettings,
                              mesh: Optional[Mesh] = None,
                              iterations: Optional[int] = None,
                              seed: int = 0, chunk: int = 64) -> jnp.ndarray:
    """Persistent work-queue engine over a device mesh.

    Each shard runs its own rotating lane<->pixel schedule over its LOCAL
    pixel block (pixel ids stay globally unique via pixel_offset, so RNG
    streams — keyed on (seed, sample, depth, global pixel) — are identical to
    the single-chip render). Zero cross-chip traffic, like the masked engine.
    """
    from ..engine.persistent import _step, fresh_lanes, pixel_stride

    if mesh is None:
        mesh = make_ray_mesh()
    spp = settings.iterations if iterations is None else iterations
    n_shards = mesh.shape[RAY_AXIS]
    n_total = settings.pixel_count
    assert n_total % n_shards == 0
    n_local = n_total // n_shards
    settings = _interleaved(settings, n_shards)
    stride = pixel_stride(n_local)

    scene_r = replicate(scene, mesh)

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(P(),),
             out_specs=P(RAY_AXIS), check_vma=False)
    def run(scene):
        shard = jax.lax.axis_index(RAY_AXIS)
        offset = shard * n_local
        state = fresh_lanes(settings, n=n_local)

        def cond(s):
            return jnp.logical_or(
                jnp.any(jnp.logical_or(s.remaining_bounces > 0,
                                       s.assign < spp)),
                s.flushed < spp)

        def body(s):
            return _step(scene, settings, seed, s, jnp.int32(spp), stride,
                         offset)

        state = jax.lax.while_loop(cond, body, state)
        return state.accum

    accum = run(scene_r)
    from ..engine.wavefront import lanes_to_image
    avg = accum * (1.0 / jnp.float32(spp))
    return lanes_to_image(avg, settings)


def scaling_efficiency(scene: SceneArrays, settings: RenderSettings,
                       shard_counts, iterations: int = 32,
                       seed: int = 0) -> dict:
    """Rays/s scaling-efficiency harness (north-star: >=85% at 2 hosts).

    Renders `iterations` spp on 1-D meshes of each size in `shard_counts`
    and reports rays/s and efficiency vs linear scaling from the smallest.
    """
    import time

    results = {}
    base = None
    for n_dev in shard_counts:
        mesh = make_ray_mesh(n_dev)
        scene_r = replicate(scene, mesh)
        accum = shard_accum(zero_accum(settings), mesh)
        # compile + warm
        out = render_chunk_sharded(scene_r, settings, mesh, accum,
                                   jnp.int32(1), iterations, seed)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        out = render_chunk_sharded(scene_r, settings, mesh, out,
                                   jnp.int32(1 + iterations), iterations,
                                   seed)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        rays_s = settings.pixel_count * iterations / dt
        if base is None:
            base = (n_dev, rays_s)
        eff = rays_s / (base[1] * n_dev / base[0])
        results[n_dev] = {"rays_per_s": rays_s, "efficiency": eff}
    return results


def shard_work_counts(scene: SceneArrays, settings: RenderSettings,
                      mesh: Mesh, iterations: int = 4,
                      seed: int = 0, interleave: bool = True) -> np.ndarray:
    """Per-shard path-tracing WORK (live lane-bounces summed over the bounce
    loop and `iterations` samples) on the given mesh.

    Why counts, not wall time: the 85% 2-host rays/s target
    (SURVEY.md §2.6) is unmeasurable on shared-core virtual CPU devices and
    on a 1-chip bench. But tracing is embarrassingly parallel with the scene
    replicated — ZERO cross-chip traffic inside the bounce loop — so the
    only *controllable* efficiency loss is per-shard work imbalance: a
    shard whose pixels' paths die early idles while the worst shard
    finishes. max/mean of these counts is therefore a machine-checkable
    upper bound proxy for achievable scaling efficiency (the psum and
    image gather are measured separately by the multihost tests).

    Returns [n_shards] int64 work counts.
    """
    n_shards = mesh.shape[RAY_AXIS]
    n_local = settings.pixel_count // n_shards
    assert settings.pixel_count % n_shards == 0
    if interleave:
        settings = _interleaved(settings, n_shards)

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(P(),),
             out_specs=P(RAY_AXIS), check_vma=False)
    def run(scene):
        shard = jax.lax.axis_index(RAY_AXIS)
        offset = shard * n_local

        def body(tot, k):
            counts = ray_survival(scene, settings, jnp.int32(1) + k,
                                  seed=seed, n=n_local, pixel_offset=offset)
            return tot + jnp.sum(counts[:-1]), None

        tot, _ = jax.lax.scan(body, jnp.int32(0),
                              jnp.arange(iterations, dtype=jnp.int32))
        return tot[None]

    scene_r = replicate(scene, mesh)
    return np.asarray(run(scene_r)).astype(np.int64)


def albedo_fit_step(scene: SceneArrays, settings: RenderSettings,
                    mesh: Mesh, target: Vec3, iteration: jnp.ndarray,
                    lr: float = 0.5, seed: int = 0):
    """One differentiable-rendering SGD step, sharded over the mesh.

    The FULL training step the driver dry-runs multi-chip: render one
    iteration with the ray pool sharded (dp over rays), compute an L2 loss
    against the sharded target image, backprop through the whole bounce loop
    (reparameterized sampling), psum the material-albedo gradient over the
    mesh, and apply SGD. Returns (new_scene, loss). The compiled step is
    built once per (settings, mesh, lr, seed) and reused.
    """
    step = _fit_program(settings, mesh, float(lr), seed)
    return step(scene, target, jnp.asarray(iteration, jnp.int32))


@lru_cache(maxsize=None)
def _fit_program(settings: RenderSettings, mesh: Mesh, lr: float, seed: int):
    n_shards = mesh.shape[RAY_AXIS]
    n_local = settings.pixel_count // n_shards
    settings = _interleaved(settings, n_shards)

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(RAY_AXIS), P()), out_specs=(P(), P()),
             check_vma=False)
    def step(scene, target, iteration):
        shard = jax.lax.axis_index(RAY_AXIS)
        offset = shard * n_local

        def loss_fn(albedo):
            mats = scene.materials._replace(color=albedo)
            s2 = scene._replace(materials=mats)
            accum = Vec3.zeros((n_local,))
            img = render_iteration(s2, settings, accum, iteration, seed=seed,
                                   early_exit=False, pixel_offset=offset,
                                   key_salt=shard)
            d = img - target
            local = jnp.sum(d.x * d.x + d.y * d.y + d.z * d.z)
            return local / (3.0 * settings.pixel_count)

        local_loss, g_local = jax.value_and_grad(loss_fn)(scene.materials.color)
        # Each shard's grad covers only its own pixels; the all-reduce
        # gives the full gradient replicated on every device (the gradient
        # all-reduce of SURVEY.md §2.6 / §5).
        g = jax.lax.psum(g_local, RAY_AXIS)
        loss = jax.lax.psum(local_loss, RAY_AXIS)
        new_color = jnp.clip(scene.materials.color - lr * g, 0.0, 1.0)
        new_scene = scene._replace(
            materials=scene.materials._replace(color=new_color))
        return new_scene, loss

    return step
