"""Ray-primitive intersection ops, vectorized over the ray pool (Vec3 SoA).

Replicates the device library in reference src/intersections.cu:
  - box_intersect:      boxIntersectionTest    (:3-57)   unit cube, object space
  - sphere_intersect:   sphereIntersectionTest (:59-113) r=0.5, object space
  - aabb_intersect:     aabbIntersect          (:116-129) slab test
  - triangle_intersect: triangleIntersect      (:132-163) Moller-Trumbore
  - mesh_intersect:     meshIntersectionTest   (:167-213) iterative BVH walk

All functions take Vec3-of-[N] ray SoA and return world-space hit distance t
(t <= 0 encodes a miss, matching the reference's -1 convention) plus normals.
The world-distance return convention is preserved, but computed directly as
the world-ray parameter (unnormalized object-space directions) instead of the
reference's normalize -> hit-point transform -> length() chain, and without
the 1e-4 getPointOnRay backoff (intersections.h:28-30) — see the per-function
docstrings for the algebra and why the difference is below image tolerance.

The scene-level dispatch (reference computeIntersectionsNaive,
src/pathtrace.cu:441-522) lives in `intersect_scene`: the geom loop unrolls
statically per geom type so XLA fuses every analytic test into one elementwise
pass over the pool; each mesh adds one batched BVH traversal.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..scene.types import CUBE, MESH, SPHERE, SceneArrays
from ..utils.vec import Vec3, mat4_apply

FLT_MAX = jnp.float32(3.402823466e38)

# mesh traversals: the GPU kernel and the plain-XLA reference walk
BVH_IMPLS = ("triton", "jnp")


def box_intersect(transform, inverse_transform, inv_transpose,
                  origin: Vec3, direction: Vec3
                  ) -> Tuple[jnp.ndarray, Vec3]:
    """Unit-cube intersection for one geom against [N] rays.

    Returns (t [N] world distance, normal Vec3); t<=0 on miss.
    Mirrors boxIntersectionTest (intersections.cu:3-57) including raw division
    (inf on axis-parallel rays) and the inside-hit tmax fallback, with one
    algebraic change: the object-space direction is NOT normalized,
    so the slab parameter t is directly the world-ray parameter
    (M(qo + qd·t) = o + d·t) and the reference's normalize + hit-point
    transform + length() world-distance recompute (intersections.cu:8,49-52)
    — an rsqrt, a mat4 apply, and a sqrt per geom per ray — all drop out. The
    reference's 1e-4 object-space hit backoff (getPointOnRay,
    intersections.h:28-30) is also dropped: t is exact; self-intersection is
    prevented by SCATTER_EPS in the shader, and the difference (~1e-4·scale)
    is far below Monte Carlo image tolerance.
    """
    qo = mat4_apply(inverse_transform, origin, 1.0)
    qd = mat4_apply(inverse_transform, direction, 0.0)

    neg = FLT_MAX
    tmin = jnp.full_like(qo.x, -neg)
    tmax = jnp.full_like(qo.x, neg)
    # Normal = +-axis one-hot, tracked componentwise (reference loop :18-40)
    nmin = Vec3.zeros(qo.x.shape, qo.x.dtype)
    nmax = Vec3.zeros(qo.x.shape, qo.x.dtype)
    axes = [Vec3(jnp.float32(1), jnp.float32(0), jnp.float32(0)),
            Vec3(jnp.float32(0), jnp.float32(1), jnp.float32(0)),
            Vec3(jnp.float32(0), jnp.float32(0), jnp.float32(1))]
    for oc, dc, axis in ((qo.x, qd.x, 0), (qo.y, qd.y, 1), (qo.z, qd.z, 2)):
        # reference divides raw (inf on axis-parallel rays); the VALUES are
        # select-masked but an inf cotangent times a zero select-tangent is
        # NaN in reverse mode, so clamp |dc| away from zero (1e-20 keeps the
        # forward t beyond any scene scale)
        dc = jnp.where(jnp.abs(dc) < 1e-20,
                       jnp.where(dc < 0, -1e-20, 1e-20), dc)
        t1 = (-0.5 - oc) / dc
        t2 = (0.5 - oc) / dc
        ta = jnp.minimum(t1, t2)
        tb = jnp.maximum(t1, t2)
        sgn = jnp.where(t2 < t1, 1.0, -1.0)
        upd_min = jnp.logical_and(ta > 0.0, ta > tmin)
        tmin = jnp.where(upd_min, ta, tmin)
        e = axes[axis]
        n_ax = Vec3(e.x * sgn, e.y * sgn, e.z * sgn)
        nmin = Vec3.where(upd_min, n_ax, nmin)
        upd_max = tb < tmax
        tmax = jnp.where(upd_max, tb, tmax)
        nmax = Vec3.where(upd_max, n_ax, nmax)

    hit = jnp.logical_and(tmax >= tmin, tmax > 0.0)
    inside = tmin <= 0.0
    t_world = jnp.where(inside, tmax, tmin)  # world parameter directly
    n_obj = Vec3.where(inside, nmax, nmin)

    normal = mat4_apply(inv_transpose, n_obj, 0.0).normalize()
    return jnp.where(hit, t_world, -1.0), normal


def sphere_intersect(transform, inverse_transform, inv_transpose,
                     origin: Vec3, direction: Vec3
                     ) -> Tuple[jnp.ndarray, Vec3]:
    """r=0.5 sphere for one geom against [N] rays (intersections.cu:59-113).

    Like box_intersect, the object-space direction is left unnormalized
    (full quadratic a·t² + 2b·t + c = 0 instead of the reference's monic
    form) so t is the world-ray parameter directly — no normalize, no
    hit-point transform, no world-distance length() (intersections.cu:64,
    104-108), no 1e-4 backoff.
    """
    radius = 0.5
    ro = mat4_apply(inverse_transform, origin, 1.0)
    rd = mat4_apply(inverse_transform, direction, 0.0)

    a = rd.dot(rd)
    b = ro.dot(rd)
    c = ro.dot(ro) - radius * radius
    radicand = b * b - a * c
    has_root = radicand >= 0.0
    # miss lanes substitute 1 BEFORE the sqrt: sqrt'(0) = inf would turn the
    # zero cotangent of the miss-select into NaN in reverse mode (the same
    # guard as ops/bsdf.py refract)
    sq = jnp.sqrt(jnp.where(has_root, jnp.maximum(radicand, 0.0), 1.0))
    inv_a = 1.0 / a
    t1 = (-b + sq) * inv_a
    t2 = (-b - sq) * inv_a

    both_neg = jnp.logical_and(t1 < 0.0, t2 < 0.0)
    both_pos = jnp.logical_and(t1 > 0.0, t2 > 0.0)
    t_world = jnp.where(both_pos, jnp.minimum(t1, t2), jnp.maximum(t1, t2))
    outside = both_pos
    hit = jnp.logical_and(has_root, jnp.logical_not(both_neg))

    p_obj = ro + rd * t_world
    normal = mat4_apply(inv_transpose, p_obj, 0.0).normalize()
    flip = jnp.where(outside, 1.0, -1.0)
    normal = normal * flip
    return jnp.where(hit, t_world, -1.0), normal


def aabb_intersect(bmin: Vec3, bmax: Vec3, origin: Vec3, inv_dir: Vec3
                   ) -> jnp.ndarray:
    """Branchless slab test (intersections.cu:116-129).

    Takes precomputed 1/direction. Returns entry t (exit t if origin inside),
    -1 on miss.
    """
    t_near = (bmin - origin) * inv_dir
    t_far = (bmax - origin) * inv_dir
    t0 = Vec3.minimum(t_near, t_far).max_component()
    t1 = Vec3.maximum(t_near, t_far).min_component()
    return jnp.where(t0 > t1, -1.0,
                     jnp.where(t0 > 0.0, t0,
                               jnp.where(t1 > 0.0, t1, -1.0)))


def triangle_intersect(v0: Vec3, v1: Vec3, v2: Vec3,
                       n0: Vec3, n1: Vec3, n2: Vec3,
                       origin: Vec3, direction: Vec3
                       ) -> Tuple[jnp.ndarray, Vec3]:
    """Moller-Trumbore with smooth normals (intersections.cu:132-163).

    Returns (t, normal) with t = -1 on miss; normal flipped toward the ray.
    """
    eps = 1e-6
    e1 = v1 - v0
    e2 = v2 - v0
    h = direction.cross(e2)
    a = e1.dot(h)
    parallel = jnp.abs(a) < eps
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = origin - v0
    u = f * s.dot(h)
    q = s.cross(e1)
    v = f * direction.dot(q)
    t = f * e2.dot(q)

    valid = jnp.logical_not(parallel)
    valid = jnp.logical_and(valid, jnp.logical_and(u >= 0.0, u <= 1.0))
    valid = jnp.logical_and(valid, jnp.logical_and(v >= 0.0, (u + v) <= 1.0))
    valid = jnp.logical_and(valid, t >= eps)

    w = 1.0 - u - v
    n = (n0 * w + n1 * u + n2 * v).normalize()
    flip = jnp.where(direction.dot(n) > 0.0, -1.0, 1.0)
    n = n * flip
    return jnp.where(valid, t, -1.0), n


def _triangle_t_uv(v0: Vec3, v1: Vec3, v2: Vec3, origin: Vec3,
                   direction: Vec3):
    """Möller-Trumbore hit test returning (t, u, v); t = -1 on miss.

    The normal interpolation of triangleIntersect (intersections.cu:155-160)
    is deferred: traversal only needs t to keep the closest hit, so the six
    normal gathers + interpolation run ONCE per ray after the walk, on the
    winning triangle (see hit_attributes).
    """
    return _triangle_t_uv_edges(v0, v1 - v0, v2 - v0, origin, direction)


def _triangle_t_uv_edges(v0: Vec3, e1: Vec3, e2: Vec3, origin: Vec3,
                         direction: Vec3):
    """`_triangle_t_uv` from the edges e1 = v1 - v0, e2 = v2 - v0 (the GPU
    kernel's triangle table stores them precomputed; ops/bvh_walk.py)."""
    eps = 1e-6
    h = direction.cross(e2)
    a = e1.dot(h)
    parallel = jnp.abs(a) < eps
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = origin - v0
    u = f * s.dot(h)
    q = s.cross(e1)
    v = f * direction.dot(q)
    t = f * e2.dot(q)

    valid = jnp.logical_not(parallel)
    valid = jnp.logical_and(valid, jnp.logical_and(u >= 0.0, u <= 1.0))
    valid = jnp.logical_and(valid, jnp.logical_and(v >= 0.0, (u + v) <= 1.0))
    valid = jnp.logical_and(valid, t >= eps)
    return jnp.where(valid, t, -1.0), u, v


def hit_attributes(tris, direction: Vec3, t_min, best_tri, best_u, best_v
                   ) -> Tuple[jnp.ndarray, Vec3, jnp.ndarray]:
    """(t, normal, material) of each ray's winning triangle, fetched once
    after the walk (triangleIntersect's interpolation, intersections.cu:
    155-160). best_tri = -1 is a miss: t = -1."""
    ti = jnp.maximum(best_tri, 0)
    w = 1.0 - best_u - best_v
    nrm = (tris.vertex("n0", ti) * w + tris.vertex("n1", ti) * best_u
           + tris.vertex("n2", ti) * best_v).normalize()
    flip = jnp.where(direction.dot(nrm) > 0.0, -1.0, 1.0)
    nrm = nrm * flip

    hit = jnp.logical_and(best_tri >= 0, t_min < FLT_MAX)
    mat = jnp.where(hit, tris.material_id[ti], -1)
    return jnp.where(hit, t_min, -1.0), nrm, mat


def mesh_intersect(scene: SceneArrays, root_node: jnp.ndarray,
                   origin: Vec3, direction: Vec3, active=None, t_bound=None
                   ) -> Tuple[jnp.ndarray, Vec3, jnp.ndarray]:
    """Batched STACKLESS BVH traversal in plain jnp (meshIntersectionTest,
    intersections.cu:167-213): the reference for the GPU kernel
    (ops/bvh_walk.py) and the differentiable mesh path.

    The reference walks an explicit per-thread stack; here the walk is a
    state machine over parent/sibling links (Hapala-style), so a lane carries
    three scalars instead of a stack and every memory access is a 1-D gather:

      ENTER(n):   AABB test (+ leaf triangle test); hit interior -> ENTER
                  left child (n+1, the flattened layout's invariant);
                  otherwise -> ADVANCE(n).
      ADVANCE(n): left child  -> ENTER(sibling[n]);
                  right child -> ADVANCE(parent[n]); root -> done.

    All lanes step together; the loop exits when every lane is done. Lanes
    where `active` is False start done (a miss); `t_bound` (the closest
    analytic hit) starts each lane's t_min, so only closer triangles count.

    Replicated reference quirk: the `boxT >= tMin` prune (intersections.cu:
    188) uses aabbIntersect's EXIT t when the ray origin is inside the node's
    box, so a subtree containing a closer hit can occasionally be pruned once
    some farther hit has set tMin. Kept for parity (affects a sub-percent
    fraction of inside-origin rays; see tests/test_intersect.py). Visit ORDER
    differs from the reference (left-first vs its pop-right-first), which can
    flip which of two quirk-eligible hits survives — same tolerance class.

    Returns (t [N], normal Vec3, material_id [N]); t = -1 on miss.
    """
    n = origin.x.shape[0]
    bvh = scene.bvh
    tris = scene.triangles
    inv_dir = 1.0 / direction

    ENTER, ADVANCE = jnp.int32(0), jnp.int32(1)
    node0 = jnp.broadcast_to(root_node, (n,)).astype(jnp.int32)
    done0 = (jnp.zeros((n,), bool) if active is None
             else jnp.logical_not(active))
    t_min0 = jnp.full((n,), FLT_MAX) if t_bound is None else t_bound
    state0 = (node0, jnp.full((n,), ENTER), done0, t_min0,
              jnp.full((n,), -1, jnp.int32), jnp.zeros((n,)), jnp.zeros((n,)))

    def cond(s):
        return jnp.logical_not(jnp.all(s[2]))

    def body(s):
        node, mode, done, t_min, best_tri, best_u, best_v = s

        bmin = Vec3(bvh.min_x[node], bvh.min_y[node], bvh.min_z[node])
        bmax = Vec3(bvh.max_x[node], bvh.max_y[node], bvh.max_z[node])
        tri_first = bvh.tri_first[node]
        tri_count = bvh.tri_count[node]
        sib = bvh.sibling[node]
        par = bvh.parent[node]

        entering = jnp.logical_and(mode == ENTER, jnp.logical_not(done))
        box_t = aabb_intersect(bmin, bmax, origin, inv_dir)
        visit = jnp.logical_and(
            entering, jnp.logical_and(box_t >= 0.0, box_t < t_min))

        is_leaf = tri_count > 0
        # Leaf: contiguous triangle range, walked with a fori over the
        # LARGEST leaf currently live in the pool (the bound is the max
        # tri_count gathered this step — dynamic, so any max_leaf works).
        max_count = jnp.max(tri_count)

        def leaf_body(j, carry):
            t_min, best_tri, best_u, best_v = carry
            ti = jnp.maximum(tri_first, 0) + j
            ti = jnp.minimum(ti, tris.v0x.shape[0] - 1)
            t_tri, u, v = _triangle_t_uv(
                tris.vertex("v0", ti), tris.vertex("v1", ti),
                tris.vertex("v2", ti), origin, direction)
            upd = jnp.logical_and(
                visit,
                jnp.logical_and(
                    jnp.logical_and(is_leaf, j < tri_count),
                    jnp.logical_and(t_tri > 0.0, t_tri < t_min)))
            t_min = jnp.where(upd, t_tri, t_min)
            best_tri = jnp.where(upd, ti, best_tri)
            best_u = jnp.where(upd, u, best_u)
            best_v = jnp.where(upd, v, best_v)
            return t_min, best_tri, best_u, best_v

        t_min, best_tri, best_u, best_v = jax.lax.fori_loop(
            0, max_count, leaf_body, (t_min, best_tri, best_u, best_v))

        descend = jnp.logical_and(visit, jnp.logical_not(is_leaf))
        has_sib = sib >= 0
        at_root = par < 0
        # ENTER lanes that don't descend behave like ADVANCE(node) this step.
        next_node = jnp.where(descend, node + 1,
                              jnp.where(has_sib, sib, jnp.maximum(par, 0)))
        next_mode = jnp.where(jnp.logical_or(descend, has_sib), ENTER, ADVANCE)
        finished = jnp.logical_and(jnp.logical_not(descend),
                                   jnp.logical_and(jnp.logical_not(has_sib),
                                                   at_root))
        done = jnp.logical_or(done, finished)
        node = jnp.where(done, node, next_node)
        mode = jnp.where(done, mode, next_mode)
        return node, mode, done, t_min, best_tri, best_u, best_v

    _, _, _, t_min, best_tri, best_u, best_v = jax.lax.while_loop(
        cond, body, state0)

    return hit_attributes(tris, direction, t_min, best_tri, best_u, best_v)


def intersect_scene(scene: SceneArrays, geom_types: Tuple[int, ...],
                    origin: Vec3, direction: Vec3,
                    bvh_impl: str = "jnp", active=None,
                    interpret: bool = False
                    ) -> Tuple[jnp.ndarray, Vec3, jnp.ndarray]:
    """Closest-hit over all geoms (computeIntersectionsNaive,
    pathtrace.cu:441-522).

    `geom_types` is the static per-geom type tuple (from RenderSettings), so
    the geom loop unrolls at trace time. `bvh_impl` picks the mesh traversal
    (see BVH_IMPLS): "triton" = the GPU kernel (ops/bvh_walk.py), "jnp" = the
    stackless walk in plain XLA. `interpret=True` runs the kernel in the
    Pallas interpreter; only CPU tests pass it.

    ANALYTIC GEOMS RUN FIRST, meshes last: the closest analytic hit per lane
    is handed to the mesh traversal as a pruning bound (t_bound), so rays
    blocked by a closer wall/sphere never enter the tree. Merge order is
    min-reduction, so results are identical to the interleaved order the
    reference uses (pathtrace.cu:441-522), up to the inside-origin prune
    quirk (mesh_intersect docstring).

    DIFFERENTIABILITY: the kernel returns its outputs under
    lax.stop_gradient. This is EXACT for material parameters — hit geometry
    (t, normal, winning material id) does not depend on albedo/emittance/
    IOR, so its true derivative w.r.t. them is zero — and it drops only the
    almost-everywhere-zero geometric term for camera parameters
    (tests/test_grad.py camera a.e.-zero test). The "jnp" walk keeps full
    end-to-end differentiability for research use.

    Returns (t [N] > 0 on hit else -1, normal Vec3, material_id [N]).
    """
    if bvh_impl not in BVH_IMPLS:
        raise ValueError(f"unknown bvh_impl {bvh_impl!r}; one of {BVH_IMPLS}")
    n = origin.x.shape[0]
    t_best = jnp.full((n,), FLT_MAX)
    n_best = Vec3.zeros((n,))
    m_best = jnp.zeros((n,), dtype=jnp.int32)
    any_hit = jnp.zeros((n,), dtype=bool)

    def merge(t, nrm, mat):
        nonlocal t_best, n_best, m_best, any_hit
        upd = jnp.logical_and(t > 0.0, t < t_best)
        t_best = jnp.where(upd, t, t_best)
        n_best = Vec3.where(upd, nrm, n_best)
        m_best = jnp.where(upd, mat, m_best)
        any_hit = jnp.logical_or(any_hit, upd)

    for i, gt in enumerate(geom_types):
        if gt == MESH:
            continue
        fn = sphere_intersect if gt == SPHERE else box_intersect
        t, nrm = fn(scene.geoms.transform[i],
                    scene.geoms.inverse_transform[i],
                    scene.geoms.inv_transpose[i],
                    origin, direction)
        merge(t, nrm, jnp.broadcast_to(scene.geoms.material_id[i], (n,)))

    if MESH in geom_types and bvh_impl == "triton":
        # one launch walks every mesh (the forest's roots are chained);
        # imported here because bvh_walk builds on this module
        from .bvh_walk import mesh_intersect_walk
        merge(*mesh_intersect_walk(scene, origin, direction, active=active,
                                   t_bound=t_best, interpret=interpret))
    else:
        for i, gt in enumerate(geom_types):
            if gt == MESH:
                merge(*mesh_intersect(scene, scene.geoms.root_node[i], origin,
                                      direction, active=active,
                                      t_bound=t_best))

    t_out = jnp.where(any_hit, t_best, -1.0)
    return t_out, n_best, m_best
