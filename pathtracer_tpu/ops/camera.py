"""Camera ray generation: stochastic AA jitter + thin-lens depth of field.

Replicates reference src/pathtrace.cu:260-322 (generateRayFromCamera) and
:235-250 (concentricSampleDisk), vectorized over the whole pixel pool on the
Vec3 SoA layout.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..scene.types import CameraArrays
from ..utils.math import PI
from ..utils.vec import Vec3


def pick_tile(width: int, height: int):
    """Largest square tile (<= 32x32) dividing the image, or None.

    Lane order is tile-major when possible: a traversal-kernel ray block then
    covers a compact pixel footprint instead of a full-width scanline strip,
    which keeps the rays of one kernel program coherent (ops/bvh_walk.py).
    """
    for t in (32, 16, 8):
        if width % t == 0 and height % t == 0:
            return (t, t)
    return None


def tile_pixel_map(width: int, height: int, tile_h: int, tile_w: int):
    """lane (tile-major) -> pixel index (row-major). Pure index math, works
    on ints and traced arrays."""
    tiles_x = width // tile_w
    tsz = tile_h * tile_w

    def f(lane):
        t = lane // tsz
        r = lane % tsz
        ty = t // tiles_x
        tx = t % tiles_x
        py = ty * tile_h + r // tile_w
        px = tx * tile_w + r % tile_w
        return py * width + px

    return f


def concentric_sample_disk(u1: jnp.ndarray, u2: jnp.ndarray):
    """Concentric disk warp (pathtrace.cu:235-250). Returns (dx, dy)."""
    sx = 2.0 * u1 - 1.0
    sy = 2.0 * u2 - 1.0
    use_x = jnp.abs(sx) > jnp.abs(sy)
    r = jnp.where(use_x, sx, sy)
    safe_sx = jnp.where(sx == 0.0, 1.0, sx)
    safe_sy = jnp.where(sy == 0.0, 1.0, sy)
    theta = jnp.where(
        use_x,
        (PI / 4.0) * (sy / safe_sx),
        (PI / 2.0) - (PI / 4.0) * (sx / safe_sy),
    )
    both_zero = jnp.logical_and(sx == 0.0, sy == 0.0)
    r = jnp.where(both_zero, 0.0, r)
    return r * jnp.cos(theta), r * jnp.sin(theta)


def generate_camera_rays(
    cam: CameraArrays,
    width: int,
    height: int,
    jitter_normals: jnp.ndarray | None,
    dof_uniforms: jnp.ndarray | None,
    n: int | None = None,
    pixel_offset=0,
    pixel_idx=None,
):
    """Generate one primary ray per pixel.

    Args:
      cam: camera parameters.
      jitter_normals: pair of [N] standard normals for AA (sigma=0.005,
        clamp +-0.5, pathtrace.cu:272-281), or None to disable (JITTER 0).
      dof_uniforms: pair of [N] uniforms for the lens sample
        (pathtrace.cu:294-315), or None to disable (DOF 0). Thin lens is
        active iff lens_radius > 0.
      n: number of rays to generate (defaults to width*height; a sharded
        caller passes its local block size).
      pixel_offset: global index of this block's first pixel (0 single-chip;
        shard offset under shard_map).
      pixel_idx: optional explicit [n] global pixel indices (the persistent
        engine's rotating lane->pixel schedule); overrides arange+offset.

    Returns:
      (origin Vec3, direction Vec3) of [N], lane i covering global pixel
      index pixel_offset + i with index = x + y*width (pathtrace.cu:266).
    """
    if n is None:
        n = width * height
    idx = (jnp.arange(n, dtype=jnp.int32) + pixel_offset
           if pixel_idx is None else pixel_idx)
    x = (idx % width).astype(jnp.float32)
    y = (idx // width).astype(jnp.float32)

    if jitter_normals is not None:
        px = x + jnp.clip(jitter_normals[0] * 0.005, -0.5, 0.5)
        py = y + jnp.clip(jitter_normals[1] * 0.005, -0.5, 0.5)
    else:
        px, py = x, y

    view = Vec3(cam.view[0], cam.view[1], cam.view[2])
    right = Vec3(cam.right[0], cam.right[1], cam.right[2])
    up = Vec3(cam.up[0], cam.up[1], cam.up[2])
    pos = Vec3(cam.position[0], cam.position[1], cam.position[2])

    # dir = normalize(view - right*plx*(px - w/2) - up*ply*(py - h/2))
    # (pathtrace.cu:286-289)
    sx = cam.pixel_length[0] * (px - 0.5 * width)
    sy = cam.pixel_length[1] * (py - 0.5 * height)
    d = (view - right * sx - up * sy).normalize()

    origin = Vec3(jnp.broadcast_to(pos.x, (n,)),
                  jnp.broadcast_to(pos.y, (n,)),
                  jnp.broadcast_to(pos.z, (n,)))

    if dof_uniforms is not None:
        # Thin-lens: focal point along the pinhole ray, lens-disk origin offset
        # (pathtrace.cu:294-315). Active iff lens_radius > 0 (runtime select,
        # so one compiled fn serves both pinhole and thin-lens cameras).
        denom = d.dot(view)
        denom = jnp.where(jnp.abs(denom) < 1e-6,
                          jnp.where(denom >= 0.0, 1e-6, -1e-6), denom)
        t_focus = cam.focal_distance / denom
        p_focus = origin + d * t_focus
        lx, ly = concentric_sample_disk(dof_uniforms[0], dof_uniforms[1])
        lx = lx * cam.lens_radius
        ly = ly * cam.lens_radius
        o_dof = origin + right * lx + up * ly
        d_dof = (p_focus - o_dof).normalize()
        enabled = cam.lens_radius > 0.0
        origin = Vec3.where(enabled, o_dof, origin)
        d = Vec3.where(enabled, d_dof, d)

    return origin, d
