"""Multi-host (multi-process) distributed execution.

The reference is single-process single-GPU (SURVEY.md §2.6: "Communication
backend: none"); this module is the from-scratch multi-host path the north
star requires: `jax.distributed.initialize` process wiring, a GLOBAL device
mesh spanning every host's chips, per-host construction of exactly the array
shards that host owns, and host-side image assembly via a process allgather.

Design (the ray-pool axis is the only big axis — SURVEY.md §5.7):
  - one 1-D mesh over ALL devices of every host; rays/pixels sharded, scene
    replicated. Tracing needs zero cross-device traffic, so the interconnect
    carries only gradient psums (differentiable path) and the final image
    fetch.
  - every process executes the SAME jitted program (SPMD); JAX requires
    multihost collectives to be launched in lockstep, which the render loop
    does naturally.
  - per-host data: each process builds only its addressable shards of the
    accumulation image (jax.make_array_from_callback), so no host ever
    materializes the full pool — the host boundary is crossed only by
    `fetch_image`'s allgather at save time.

Tested with N processes on CPU (tests/test_multihost.py spawns real
processes with a localhost coordinator). On GPU hosts pass the coordinator
address, process count and process id explicitly.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..scene.types import RenderSettings, SceneArrays
from ..utils.vec import Vec3
from .sharding import (RAY_AXIS, _interleaved, render_chunk_sharded,
                       replicate)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Wire this process into the multi-host job.

    Pass the coordinator address (`host:port`), the process count and this
    process's id; tests use a localhost coordinator. Must run before any
    other JAX call that touches a backend.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_ray_mesh() -> Mesh:
    """1-D mesh over every chip of every host (global devices)."""
    return Mesh(np.asarray(jax.devices()), (RAY_AXIS,))


def make_global_accum(settings: RenderSettings, mesh: Mesh) -> Vec3:
    """Zero accumulation image sharded over the global mesh; each process
    materializes ONLY its own shards."""
    n = settings.pixel_count
    sh = NamedSharding(mesh, P(RAY_AXIS))

    def zeros(_index):
        return np.zeros((n // mesh.size,), np.float32)

    mk = lambda: jax.make_array_from_callback((n,), sh, zeros)
    return Vec3(mk(), mk(), mk())


def fetch_image(accum: Vec3, settings: RenderSettings,
                iterations: int) -> np.ndarray:
    """Assemble the full averaged [H,W,3] image on EVERY host.

    One allgather over DCN (the only cross-host data movement of a render);
    the per-bounce loop never communicates.
    """
    from jax.experimental import multihost_utils

    from ..engine.wavefront import lanes_to_image

    parts = [np.asarray(multihost_utils.process_allgather(c, tiled=True))
             for c in accum]
    avg = Vec3(*(jnp.asarray(p) for p in parts)) * (1.0 / float(iterations))
    # lane->pixel unscramble must match the render-time shard interleave
    # (render_chunk_sharded applies it internally, keyed on the mesh size)
    n_shards = len(accum.x.sharding.device_set)
    return lanes_to_image(avg, _interleaved(settings, n_shards))


def render_distributed(scene: SceneArrays, settings: RenderSettings,
                       iterations: Optional[int] = None, seed: int = 0,
                       chunk: int = 16) -> np.ndarray:
    """Full progressive render over the global (multi-host) mesh.

    Every process calls this with the same arguments; returns the assembled
    [H,W,3] image on every host (identical to the single-process render:
    RNG streams are keyed on global pixel ids, not on hosts or shards).
    """
    mesh = global_ray_mesh()
    n_total = settings.iterations if iterations is None else iterations
    scene_r = replicate(scene, mesh)
    accum = make_global_accum(settings, mesh)
    done = 0
    while done < n_total:
        this = min(chunk, n_total - done)
        accum = render_chunk_sharded(scene_r, settings, mesh, accum,
                                     jnp.int32(done + 1), this, seed)
        done += this
    return fetch_image(accum, settings, n_total)
