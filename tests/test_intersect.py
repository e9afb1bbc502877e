"""Unit tests: intersection ops vs independent NumPy oracles.

The oracles re-derive box/sphere/triangle intersection from first principles
(transform to object space, solve, transform back) rather than mirroring the
op code, so they catch transcription bugs in the Vec3 SoA implementations.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.ops.intersect import (aabb_intersect, box_intersect,
                                          intersect_scene, mesh_intersect,
                                          sphere_intersect,
                                          triangle_intersect)
from pathtracer_tpu.scene.bvh import build_bvh
from pathtracer_tpu.scene.types import make_scene_arrays
from pathtracer_tpu.utils.math import build_transformation_matrix, inverse_transpose
from pathtracer_tpu.utils.vec import Vec3

RNG = np.random.default_rng(7)


def rays(n, spread=4.0, origin_z=6.0):
    o = RNG.normal(0, spread, (n, 3)).astype(np.float32)
    o[:, 2] += origin_z
    d = RNG.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def as_vec3(a):
    return Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


def oracle_sphere(transform, o, d):
    """Closest world-space hit distance of a TRS-transformed r=0.5 sphere."""
    inv = np.linalg.inv(transform)
    n = o.shape[0]
    ts = np.full(n, -1.0)
    for i in range(n):
        ro = (inv @ np.append(o[i], 1.0))[:3]
        rd = (inv @ np.append(d[i], 0.0))[:3]
        rd = rd / np.linalg.norm(rd)
        b = np.dot(ro, rd)
        c = np.dot(ro, ro) - 0.25
        disc = b * b - c
        if disc < 0:
            continue
        r1, r2 = -b - np.sqrt(disc), -b + np.sqrt(disc)
        t = r1 if r1 > 0 else (r2 if r2 > 0 else None)
        if t is None:
            continue
        p_obj = ro + (t - 1e-4) * rd
        p_world = (transform @ np.append(p_obj, 1.0))[:3]
        ts[i] = np.linalg.norm(o[i] - p_world)
    return ts


def oracle_box(transform, o, d):
    """Slab-test oracle for the unit cube under `transform`."""
    inv = np.linalg.inv(transform)
    n = o.shape[0]
    ts = np.full(n, -1.0)
    for i in range(n):
        ro = (inv @ np.append(o[i], 1.0))[:3]
        rd = (inv @ np.append(d[i], 0.0))[:3]
        rd = rd / np.linalg.norm(rd)
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (-0.5 - ro) / rd
            t2 = (0.5 - ro) / rd
        tmin = np.nanmax(np.where(np.minimum(t1, t2) > 0,
                                  np.minimum(t1, t2), -np.inf))
        tmax = np.nanmin(np.maximum(t1, t2))
        if tmax < tmin or tmax <= 0:
            continue
        t = tmin if tmin > 0 else tmax
        p_obj = ro + (t - 1e-4) * rd
        p_world = (transform @ np.append(p_obj, 1.0))[:3]
        ts[i] = np.linalg.norm(o[i] - p_world)
    return ts


@pytest.mark.parametrize("trs", [
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    ((1.0, -2.0, 0.5), (30.0, 45.0, 10.0), (2.0, 0.5, 3.0)),
])
def test_sphere_vs_oracle(trs):
    tf = build_transformation_matrix(*trs)
    o, d = rays(500)
    t, _ = sphere_intersect(jnp.asarray(tf, jnp.float32),
                            jnp.asarray(np.linalg.inv(tf), jnp.float32),
                            jnp.asarray(inverse_transpose(tf), jnp.float32),
                            as_vec3(o), as_vec3(d))
    expect = oracle_sphere(tf, o.astype(np.float64), d.astype(np.float64))
    got = np.asarray(t)
    hit_agree = (got > 0) == (expect > 0)
    assert hit_agree.mean() > 0.995  # float32 grazing rays may flip
    both = (got > 0) & (expect > 0)
    np.testing.assert_allclose(got[both], expect[both], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("trs", [
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    ((0.5, 1.0, -1.0), (0.0, 30.0, 60.0), (3.0, 0.2, 1.5)),
])
def test_box_vs_oracle(trs):
    tf = build_transformation_matrix(*trs)
    o, d = rays(500)
    t, _ = box_intersect(jnp.asarray(tf, jnp.float32),
                         jnp.asarray(np.linalg.inv(tf), jnp.float32),
                         jnp.asarray(inverse_transpose(tf), jnp.float32),
                         as_vec3(o), as_vec3(d))
    expect = oracle_box(tf, o.astype(np.float64), d.astype(np.float64))
    got = np.asarray(t)
    hit_agree = (got > 0) == (expect > 0)
    assert hit_agree.mean() > 0.99
    both = (got > 0) & (expect > 0)
    np.testing.assert_allclose(got[both], expect[both], rtol=2e-3, atol=2e-3)


def test_sphere_normal_outward_and_inside_flip():
    tf = build_transformation_matrix((0, 0, 0), (0, 0, 0), (2, 2, 2))
    inv = np.linalg.inv(tf)
    o = np.array([[0.0, 0.0, 5.0], [0.0, 0.0, 0.0]], dtype=np.float32)
    d = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], dtype=np.float32)
    t, nrm = sphere_intersect(jnp.asarray(tf, jnp.float32),
                              jnp.asarray(inv, jnp.float32),
                              jnp.asarray(inverse_transpose(tf), jnp.float32),
                              as_vec3(o), as_vec3(d))
    t = np.asarray(t)
    n = np.stack([np.asarray(nrm.x), np.asarray(nrm.y), np.asarray(nrm.z)], -1)
    assert abs(t[0] - 4.0) < 1e-2          # front face of r=1 sphere from z=5
    np.testing.assert_allclose(n[0], [0, 0, 1], atol=1e-5)   # outward
    np.testing.assert_allclose(n[1], [0, 0, 1], atol=1e-5)   # inside: flipped


def test_aabb_basic():
    bmin = Vec3(jnp.float32(-1), jnp.float32(-1), jnp.float32(-1))
    bmax = Vec3(jnp.float32(1), jnp.float32(1), jnp.float32(1))
    o = as_vec3(np.array([[0, 0, 5], [0, 0, 5], [0, 0, 0]], dtype=np.float32))
    d = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], dtype=np.float32)
    with np.errstate(divide="ignore"):   # inf inv on parallel axes is the
        inv_d = as_vec3(1.0 / d)         # slab test's intended input
    t = np.asarray(aabb_intersect(bmin, bmax, o, inv_d))
    assert abs(t[0] - 4.0) < 1e-5   # enters at z=1
    assert t[1] == -1.0              # parallel miss
    assert abs(t[2] - 1.0) < 1e-5   # origin inside: exit t


def test_triangle_moller_trumbore():
    v0 = as_vec3(np.array([[-1, -1, 0]], dtype=np.float32))
    v1 = as_vec3(np.array([[1, -1, 0]], dtype=np.float32))
    v2 = as_vec3(np.array([[0, 1, 0]], dtype=np.float32))
    nz = as_vec3(np.array([[0, 0, 1]], dtype=np.float32))
    o = as_vec3(np.array([[0, 0, 3]], dtype=np.float32))
    d = as_vec3(np.array([[0, 0, -1]], dtype=np.float32))
    t, n = triangle_intersect(v0, v1, v2, nz, nz, nz, o, d)
    assert abs(float(t[0]) - 3.0) < 1e-5
    # normal flipped toward the ray
    assert float(n.z[0]) == pytest.approx(1.0, abs=1e-5)
    # miss outside barycentric range
    o2 = as_vec3(np.array([[5, 5, 3]], dtype=np.float32))
    t2, _ = triangle_intersect(v0, v1, v2, nz, nz, nz, o2, d)
    assert float(t2[0]) == -1.0


def _random_mesh_scene(n_tris=64, max_leaf=4):
    """Random triangle soup + BVH, wrapped in SceneArrays."""
    v = RNG.normal(0, 1.5, (n_tris, 3, 3)).astype(np.float32)
    v[:, :, 2] -= 3.0
    tris = {
        "v0": v[:, 0], "v1": v[:, 1], "v2": v[:, 2],
        "n0": np.tile([0, 0, 1], (n_tris, 1)).astype(np.float32),
        "n1": np.tile([0, 0, 1], (n_tris, 1)).astype(np.float32),
        "n2": np.tile([0, 0, 1], (n_tris, 1)).astype(np.float32),
        "material_id": np.arange(n_tris, dtype=np.int32) % 5,
    }
    nodes, reordered = build_bvh(tris, max_leaf=max_leaf)
    geoms = [{"type": 2, "material_id": 0,
              "transform": np.eye(4), "inverse_transform": np.eye(4),
              "inv_transpose": np.eye(4), "root_node": 0}]
    mats = [{"color": (0.5, 0.5, 0.5)}]
    cam = {"position": (0, 0, 5), "view": (0, 0, -1), "up": (0, 1, 0),
           "right": (1, 0, 0), "pixel_length": (0.01, 0.01),
           "lens_radius": 0.0, "focal_distance": 10.0}
    scene = make_scene_arrays(geoms, mats, nodes, reordered, cam)
    return scene, v


def oracle_mesh_bvh(scene, o, d):
    """Python replica of the REFERENCE traversal semantics (intersections.cu:
    167-213) including its inside-origin pruning quirk, but visiting LEFT
    child first to match our stackless walk (the reference pops right-first;
    with the t_min-dependent quirk prune, visit order can flip which of two
    quirk-eligible hits survives — same tolerance class, see mesh_intersect
    docstring)."""
    import numpy as np
    bvh = scene.bvh
    mn = np.stack([np.asarray(bvh.min_x), np.asarray(bvh.min_y),
                   np.asarray(bvh.min_z)], -1)
    mx = np.stack([np.asarray(bvh.max_x), np.asarray(bvh.max_y),
                   np.asarray(bvh.max_z)], -1)
    tf_arr = np.asarray(bvh.tri_first)
    tc_arr = np.asarray(bvh.tri_count)
    sc = np.asarray(bvh.second_child)
    tris = scene.triangles
    V0 = np.stack([np.asarray(tris.v0x), np.asarray(tris.v0y),
                   np.asarray(tris.v0z)], -1).astype(np.float64)
    V1 = np.stack([np.asarray(tris.v1x), np.asarray(tris.v1y),
                   np.asarray(tris.v1z)], -1).astype(np.float64)
    V2 = np.stack([np.asarray(tris.v2x), np.asarray(tris.v2y),
                   np.asarray(tris.v2z)], -1).astype(np.float64)

    def aabb(bmin, bmax, oo, dd):
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / dd
        tn = (bmin - oo) * inv
        tf = (bmax - oo) * inv
        t0 = np.minimum(tn, tf).max()
        t1 = np.maximum(tn, tf).min()
        if t0 > t1:
            return -1.0
        return t0 if t0 > 0 else (t1 if t1 > 0 else -1.0)

    def tri_t(a, b, c, oo, dd):
        e1, e2 = b - a, c - a
        h = np.cross(dd, e2)
        aa = np.dot(e1, h)
        if abs(aa) < 1e-6:
            return -1.0
        f = 1.0 / aa
        s = oo - a
        u = f * np.dot(s, h)
        if u < 0 or u > 1:
            return -1.0
        q = np.cross(s, e1)
        vv = f * np.dot(dd, q)
        if vv < 0 or u + vv > 1:
            return -1.0
        t = f * np.dot(e2, q)
        return t if t >= 1e-6 else -1.0

    out = np.full(o.shape[0], -1.0)
    for i in range(o.shape[0]):
        oo, dd = o[i], d[i]
        stack, tmin = [0], np.inf
        while stack:
            idx = stack.pop()
            bt = aabb(mn[idx], mx[idx], oo, dd)
            if bt < 0 or bt >= tmin:
                continue
            if tc_arr[idx] > 0:
                for k in range(tf_arr[idx], tf_arr[idx] + tc_arr[idx]):
                    t = tri_t(V0[k], V1[k], V2[k], oo, dd)
                    if 0 < t < tmin:
                        tmin = t
            else:
                stack.append(sc[idx])
                stack.append(idx + 1)
        if np.isfinite(tmin):
            out[i] = tmin
    return out


def oracle_mesh(v, o, d):
    """Brute force closest triangle hit over the soup (float64)."""
    n = o.shape[0]
    out = np.full(n, -1.0)
    for i in range(n):
        best = np.inf
        for tri in v:
            e1 = tri[1] - tri[0]
            e2 = tri[2] - tri[0]
            h = np.cross(d[i], e2)
            a = np.dot(e1, h)
            if abs(a) < 1e-6:
                continue
            f = 1.0 / a
            s = o[i] - tri[0]
            u = f * np.dot(s, h)
            if u < 0 or u > 1:
                continue
            q = np.cross(s, e1)
            vv = f * np.dot(d[i], q)
            if vv < 0 or u + vv > 1:
                continue
            t = f * np.dot(e2, q)
            if t >= 1e-6 and t < best:
                best = t
        if np.isfinite(best):
            out[i] = best
    return out


def test_mesh_bvh_matches_reference_traversal():
    """Kernel must match the reference traversal bit-for-bit in behavior
    (including its inside-origin pruning quirk, intersections.cu:188)."""
    scene, v = _random_mesh_scene(64)
    o, d = rays(200, spread=2.0, origin_z=4.0)
    t, _, mat = mesh_intersect(scene, jnp.int32(0), as_vec3(o), as_vec3(d))
    got = np.asarray(t)
    expect = oracle_mesh_bvh(scene, o.astype(np.float64), d.astype(np.float64))
    agree = (got > 0) == (expect > 0)
    assert agree.mean() > 0.995
    both = (got > 0) & (expect > 0)
    np.testing.assert_allclose(got[both], expect[both], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("max_leaf", [1, 2, 4, 8])
def test_mesh_bvh_oracle_leaf_sizes(max_leaf):
    """The jnp walk against the float64 oracle of the reference traversal
    at every leaf size the loader may choose (scene/loader.py MAX_LEAF)."""
    scene, v = _random_mesh_scene(96, max_leaf=max_leaf)
    assert int(np.asarray(scene.bvh.tri_count).max()) <= max_leaf
    # rays toward scattered triangle centroids: most hit, some graze
    o, _ = rays(200, spread=2.0, origin_z=4.0)
    target = v.mean(axis=1)[RNG.integers(0, v.shape[0], 200)]
    target = target + RNG.normal(0, 0.1, target.shape).astype(np.float32)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t, _, _ = mesh_intersect(scene, jnp.int32(0), as_vec3(o), as_vec3(d))
    got = np.asarray(t)
    expect = oracle_mesh_bvh(scene, o.astype(np.float64),
                             d.astype(np.float64))
    assert (expect > 0).mean() > 0.5
    agree = (got > 0) == (expect > 0)
    assert agree.mean() > 0.995
    both = (got > 0) & (expect > 0)
    np.testing.assert_allclose(got[both], expect[both], rtol=1e-3, atol=1e-3)


def test_mesh_bvh_close_to_true_closest():
    """And it should almost always equal the TRUE closest hit: the pruning
    quirk may only affect a tiny fraction of rays, and never produce a hit
    closer than the true closest."""
    scene, v = _random_mesh_scene(64)
    o, d = rays(1500, spread=1.0, origin_z=4.0)
    t, _, _ = mesh_intersect(scene, jnp.int32(0), as_vec3(o), as_vec3(d))
    got = np.asarray(t)
    truth = oracle_mesh(v.astype(np.float64), o.astype(np.float64),
                        d.astype(np.float64))
    both = (got > 0) & (truth > 0)
    # never closer than truth (within float tolerance)
    assert (got[both] >= truth[both] - 1e-3).all()
    exact = np.isclose(got[both], truth[both], rtol=1e-3, atol=1e-3)
    assert exact.mean() > 0.97


def test_intersect_scene_picks_closest(cornell_small):
    scene, settings = cornell_small
    o = as_vec3(np.array([[0, 5, 10.5], [3, 5, 10.5]], dtype=np.float32))
    d = as_vec3(np.array([[0, 0, -1], [0, 0, -1]], dtype=np.float32))
    t, nrm, mat = intersect_scene(scene, settings.geom_types, o, d)
    # Ray 0 hits the mirror sphere (center (-1,4,-1), r=1.5, passes at
    # lateral distance sqrt(2)): z = -1 + sqrt(1.5^2-2) -> t ~= 11.0
    assert abs(float(t[0]) - (10.5 + 1 - np.sqrt(0.25))) < 0.01
    assert int(mat[0]) == 4  # specular_white
    # Ray 1 misses the sphere, hits the back wall (z=-5 + half-thickness)
    assert abs(float(t[1]) - 15.495) < 0.02
    assert int(mat[1]) == 1  # diffuse_white
