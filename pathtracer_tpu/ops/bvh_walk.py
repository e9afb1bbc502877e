"""Mesh closest-hit as one Pallas kernel for the GPU (Triton route).

One ray per lane walks the SAH BVH of every mesh in the scene, the GPU
mapping of the reference's per-thread traversal (meshIntersectionTest,
intersections.cu:167-213). The walk is the stackless one of
ops/intersect.py `mesh_intersect`, so the two return the same hits:

  - left child first (node + 1 in the DFS layout), then the right sibling;
  - the reference's inside-origin prune quirk (`box_t < t_min` with the
    box's EXIT t when the origin is inside it);
  - `active` lanes only, starting from the caller's `t_bound` (the closest
    analytic hit), so rays blocked by a closer wall never enter the tree.

The jnp walk spends a separate step on each ADVANCE (climbing to the
parent); here a per-node ESCAPE link (the node ADVANCE would next ENTER,
precomputed on the host) replaces that climb, so every step of the loop is
one node visit. The root of each mesh escapes to the root of the next one,
so one launch walks the whole forest with the closest hit carried across
meshes, exactly as `intersect_scene` merges the per-mesh jnp walks.

A lane keeps its node, best t and best triangle in registers for the whole
walk. Node and triangle records are read with per-lane gathers from tables
in global memory, which sit in the GPU's L2 (alien: 46,588 triangles x 36 B
= 1.7 MB, computed). Normals and the material are fetched once per ray
after the walk, by the same epilogue as the jnp walk.

Tables (built on the host by `pack_walk_tables`):
  nodes [N * 8] i32, one 32-byte record per node: min xyz and max xyz as
      float32 bit patterns, then (tri_first << 8 | tri_count) for a leaf or
      0 for an interior node, then the escape link (-1 ends the walk).
  tris  [T * 9] f32: v0, e1 = v1 - v0, e2 = v2 - v0 per triangle.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..utils.vec import Vec3
from .intersect import (FLT_MAX, _triangle_t_uv_edges, aabb_intersect,
                        hit_attributes)

NODE_STRIDE = 8
TRI_STRIDE = 9
COUNT_BITS = 8          # leaf triangle count field of a node record
# launch shape, swept on the H100 over (64, 2), (128, 4), (128, 2),
# (256, 4), (256, 8) rays per program and warps (PERF.md, tools/walk_sweep.py)
BLOCK = 64              # rays per program
NUM_WARPS = 2           # one ray per thread


def escape_links(parent: np.ndarray, sibling: np.ndarray) -> np.ndarray:
    """Node ADVANCE would ENTER next, for every node of a DFS-ordered forest.

    A left child escapes to its right sibling; any other node escapes where
    its parent does; a root escapes to the next root (-1 after the last).
    Parents precede children in DFS preorder, so one forward pass suffices.
    """
    parent = np.asarray(parent).tolist()
    sibling = np.asarray(sibling).tolist()
    roots = [i for i, p in enumerate(parent) if p < 0]
    next_root = dict(zip(roots, roots[1:] + [-1]))
    esc = [0] * len(parent)
    for i, (p, s) in enumerate(zip(parent, sibling)):
        esc[i] = s if s >= 0 else (esc[p] if p >= 0 else next_root[i])
    return np.asarray(esc, np.int32)


def pack_walk_tables(nodes: dict, tris: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(nodes [N*8] i32, tris [T*9] f32) kernel tables from the loader's
    concatenated host BVH (see the module docstring for the layout)."""
    count = np.asarray(nodes["tri_count"], np.int64)
    first = np.asarray(nodes["tri_first"], np.int64)
    assert count.max(initial=0) < (1 << COUNT_BITS), "leaf too large"
    assert first.max(initial=0) < (1 << (31 - COUNT_BITS)), "mesh too large"
    rec = np.zeros((count.shape[0], NODE_STRIDE), np.int32)
    rec[:, 0:3] = np.asarray(nodes["bounds_min"], np.float32).view(np.int32)
    rec[:, 3:6] = np.asarray(nodes["bounds_max"], np.float32).view(np.int32)
    rec[:, 6] = np.where(count > 0, (first << COUNT_BITS) | count, 0)
    rec[:, 7] = escape_links(nodes["parent"], nodes["sibling"])

    v0 = np.asarray(tris["v0"], np.float32)
    t = np.concatenate([v0, np.asarray(tris["v1"], np.float32) - v0,
                        np.asarray(tris["v2"], np.float32) - v0], axis=1)
    return rec.reshape(-1), np.ascontiguousarray(t, np.float32).reshape(-1)


def _walk_kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tb_ref,
                 live_ref, nodes_ref, tris_ref,
                 t_ref, tri_ref, u_ref, v_ref):
    origin = Vec3(ox_ref[...], oy_ref[...], oz_ref[...])
    direction = Vec3(dx_ref[...], dy_ref[...], dz_ref[...])
    inv_dir = 1.0 / direction
    done0 = live_ref[...] == 0
    zeros_i = jnp.zeros(done0.shape, jnp.int32)
    zeros_f = jnp.zeros(done0.shape, jnp.float32)

    def cond(s):
        return jnp.min(s[1].astype(jnp.int32)) == 0

    def body(s):
        node, done, t_min, best_tri, best_u, best_v = s
        live = jnp.logical_not(done)
        base = node * NODE_STRIDE

        def field(k):
            return plgpu.load(nodes_ref.at[base + k], mask=live, other=0)

        def bound(k):
            return jax.lax.bitcast_convert_type(field(k), jnp.float32)

        bmin = Vec3(bound(0), bound(1), bound(2))
        bmax = Vec3(bound(3), bound(4), bound(5))
        leaf_word = field(6)
        esc = field(7)
        count = leaf_word & ((1 << COUNT_BITS) - 1)
        first = leaf_word >> COUNT_BITS

        box_t = aabb_intersect(bmin, bmax, origin, inv_dir)
        visit = live & (box_t >= 0.0) & (box_t < t_min)
        in_leaf = visit & (count > 0)
        n_tri = jnp.max(jnp.where(in_leaf, count, 0))

        def tri_body(j, carry):
            t_min, best_tri, best_u, best_v = carry
            m = in_leaf & (j < count)
            ti = first + j
            tbase = ti * TRI_STRIDE

            def tf(k):
                return plgpu.load(tris_ref.at[tbase + k], mask=m, other=0.0)

            v0 = Vec3(tf(0), tf(1), tf(2))
            e1 = Vec3(tf(3), tf(4), tf(5))
            e2 = Vec3(tf(6), tf(7), tf(8))
            t_tri, u, v = _triangle_t_uv_edges(v0, e1, e2, origin, direction)
            upd = m & (t_tri > 0.0) & (t_tri < t_min)
            return (jnp.where(upd, t_tri, t_min), jnp.where(upd, ti, best_tri),
                    jnp.where(upd, u, best_u), jnp.where(upd, v, best_v))

        t_min, best_tri, best_u, best_v = jax.lax.fori_loop(
            0, n_tri, tri_body, (t_min, best_tri, best_u, best_v))

        descend = visit & (count == 0)
        finished = live & jnp.logical_not(descend) & (esc < 0)
        nxt = jnp.where(descend, node + 1, esc)
        done = done | finished
        node = jnp.where(done, node, nxt)
        return node, done, t_min, best_tri, best_u, best_v

    state = (zeros_i, done0, tb_ref[...], zeros_i - 1, zeros_f, zeros_f)
    _, _, t_min, best_tri, best_u, best_v = jax.lax.while_loop(
        cond, body, state)
    t_ref[...] = t_min
    tri_ref[...] = best_tri
    u_ref[...] = best_u
    v_ref[...] = best_v


def walk_closest(nodes: jnp.ndarray, tris: jnp.ndarray, origin: Vec3,
                 direction: Vec3, active: jnp.ndarray, t_bound: jnp.ndarray,
                 *, interpret: bool = False, block: int | None = None,
                 num_warps: int | None = None):
    """Raw walk over the packed tables: (t_min, best_tri, u, v), each [N].

    best_tri = -1 where no triangle is closer than `t_bound` (t_min is then
    t_bound). The pool is padded to a multiple of `block` (default BLOCK)
    with inactive lanes. `interpret=True` runs the Pallas interpreter (CPU
    tests)."""
    block = block or BLOCK
    num_warps = num_warps or NUM_WARPS
    n = origin.x.shape[0]
    n_pad = -(-n // block) * block

    def pad(a, value):
        return jnp.pad(a, (0, n_pad - n), constant_values=value)

    ins = [pad(c, 0.0) for c in origin] + [pad(c, 1.0) for c in direction]
    ins += [pad(t_bound.astype(jnp.float32), 0.0),
            pad(active.astype(jnp.int32), 0)]
    lane = pl.BlockSpec((block,), lambda i: (i,))
    table = pl.BlockSpec(memory_space=pl.ANY)
    out = pl.pallas_call(
        _walk_kernel,
        grid=(n_pad // block,),
        in_specs=[lane] * 8 + [table, table],
        out_specs=[lane] * 4,
        out_shape=[jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.float32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="bvh_walk",
    )(*ins, nodes, tris)
    return tuple(a[:n] for a in out)


def mesh_intersect_walk(scene, origin: Vec3, direction: Vec3,
                        active=None, t_bound=None, *, interpret: bool = False
                        ) -> Tuple[jnp.ndarray, Vec3, jnp.ndarray]:
    """Closest hit over every mesh of the scene, under stop_gradient.

    Same contract as ops/intersect.py `mesh_intersect` (t = -1 on a miss or
    where nothing is closer than `t_bound`). The outputs are constants to
    autodiff: exact for material parameters, which hit geometry does not
    depend on; the jnp walk stays the differentiable one."""
    n = origin.x.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)
    if t_bound is None:
        t_bound = jnp.full((n,), FLT_MAX)
    origin, direction, t_bound = jax.lax.stop_gradient(
        (origin, direction, t_bound))
    t_min, best_tri, u, v = walk_closest(
        scene.walk_nodes, scene.walk_tris, origin, direction, active,
        t_bound, interpret=interpret)
    return jax.lax.stop_gradient(hit_attributes(
        scene.triangles, direction, t_min, best_tri, u, v))
