"""The GPU mesh kernel (ops/bvh_walk.py) against the jnp walk.

Here the kernel runs in the Pallas interpreter (interpret=True); on the card
the same walk is compiled through Triton (the `gpu` test at the end, and
chip_smoke.py `agree` at 640,000 rays). Both walks use the same arithmetic
helpers, so on the CPU they agree bit for bit.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu import load_scene
from pathtracer_tpu.ops.bvh_walk import (BLOCK, escape_links,
                                         mesh_intersect_walk,
                                         pack_walk_tables, walk_closest)
from pathtracer_tpu.ops.intersect import FLT_MAX, intersect_scene
from pathtracer_tpu.scene.bvh import build_bvh
from pathtracer_tpu.scene.fixtures import scene_path
from pathtracer_tpu.scene.types import make_scene_arrays
from pathtracer_tpu.utils.vec import Vec3

RNG = np.random.default_rng(11)


def _vec(a):
    return Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]),
                jnp.asarray(a[:, 2]))


def _soup_scene(n_tris=64):
    v = RNG.normal(0, 1.5, (n_tris, 3, 3)).astype(np.float32)
    v[:, :, 2] -= 3.0
    nz = np.tile([0, 0, 1], (n_tris, 1)).astype(np.float32)
    tris = {"v0": v[:, 0], "v1": v[:, 1], "v2": v[:, 2],
            "n0": nz, "n1": nz, "n2": nz,
            "material_id": np.arange(n_tris, dtype=np.int32) % 5}
    nodes, reordered = build_bvh(tris, max_leaf=4)
    geoms = [{"type": 2, "material_id": 0, "transform": np.eye(4),
              "inverse_transform": np.eye(4), "inv_transpose": np.eye(4),
              "root_node": 0}]
    cam = {"position": (0, 0, 5), "view": (0, 0, -1), "up": (0, 1, 0),
           "right": (1, 0, 0), "pixel_length": (0.01, 0.01),
           "lens_radius": 0.0, "focal_distance": 10.0}
    scene = make_scene_arrays(geoms, [{"color": (0.5, 0.5, 0.5)}], nodes,
                              reordered, cam)
    return scene, (2,)


def _two_mesh_scene(tmp_path):
    obj = "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nf 1 2 3\nf 1 3 4\n"
    p = tmp_path / "quad.obj"
    p.write_text(obj)
    scene_json = {
        "Materials": {"a": {"TYPE": "Diffuse", "RGB": [0.9, 0.9, 0.9]},
                      "b": {"TYPE": "Diffuse", "RGB": [0.9, 0.1, 0.1]}},
        "Camera": {"RES": [8, 8], "FOVY": 45.0, "ITERATIONS": 1, "DEPTH": 2,
                   "FILE": "x", "EYE": [0, 0, 5], "LOOKAT": [0, 0, 0],
                   "UP": [0, 1, 0]},
        "Objects": [
            {"TYPE": "mesh", "FILE": str(p), "MATERIAL": "a",
             "TRANS": [-0.5, 0, -2], "ROTAT": [0, 20, 0], "SCALE": [1, 1, 1]},
            {"TYPE": "mesh", "FILE": str(p), "MATERIAL": "b",
             "TRANS": [0.5, 0, -3], "ROTAT": [10, 0, 0], "SCALE": [2, 2, 2]},
        ],
    }
    jp = tmp_path / "two.json"
    jp.write_text(json.dumps(scene_json))
    scene, settings = load_scene(str(jp), orbit=False)
    return scene, settings.geom_types


def _subsampled_alien(tmp_path):
    """Every 16th face of the alien OBJ (about 2,900 triangles)."""
    from pathtracer_tpu.scene.fixtures import model_path

    lines = open(model_path("alienanimal.obj")).read().splitlines()
    faces = [ln for ln in lines if ln.startswith("f ")]
    keep = [ln for ln in lines if not ln.startswith("f ")] + faces[::16]
    (tmp_path / "alien_sub.obj").write_text("\n".join(keep) + "\n")
    data = json.load(open(scene_path("animal")))
    for o in data["Objects"]:
        if o["TYPE"] == "mesh":
            o["FILE"] = str(tmp_path / "alien_sub.obj")
    data["Camera"]["RES"] = [16, 16]
    jp = tmp_path / "alien_sub.json"
    jp.write_text(json.dumps(data))
    scene, settings = load_scene(str(jp))
    return scene, settings.geom_types


def _mesh_scene(name, tmp_path):
    if name == "soup":
        return _soup_scene()
    if name == "two_meshes":
        return _two_mesh_scene(tmp_path)
    if name == "alien_sub":
        return _subsampled_alien(tmp_path)
    scene, settings = load_scene(scene_path(name),
                                 overrides={"RES": [16, 16]})
    return scene, settings.geom_types


def _rays_at(scene, n):
    """Rays from around the scene's camera toward its triangles' centroids
    (a little scattered, so some graze edges or miss)."""
    tris = scene.triangles
    c = sum(np.stack([np.asarray(getattr(tris, f"{k}x")),
                      np.asarray(getattr(tris, f"{k}y")),
                      np.asarray(getattr(tris, f"{k}z"))], -1)
            for k in ("v0", "v1", "v2")) / 3.0
    target = c[RNG.integers(0, c.shape[0], n)]
    target = target + RNG.normal(0, 0.02, target.shape)
    o = (np.asarray(scene.camera.position)[None]
         + RNG.normal(0, 0.3, (n, 3))).astype(np.float32)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _assert_same(a, b):
    (t1, n1, m1), (t2, n2, m2) = a, b
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
    for c1, c2 in zip(n1, n2):
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))


@pytest.mark.parametrize("active", ["all", "half"])
@pytest.mark.parametrize("name", ["soup", "teapot", "two_meshes",
                                  "alien_sub"])
def test_kernel_matches_jnp_walk(name, active, tmp_path):
    scene, geom_types = _mesh_scene(name, tmp_path)
    o, d = _rays_at(scene, 300)
    act = None if active == "all" else jnp.asarray(RNG.random(300) < 0.5)
    ref = intersect_scene(scene, geom_types, _vec(o), _vec(d),
                          bvh_impl="jnp", active=act)
    got = intersect_scene(scene, geom_types, _vec(o), _vec(d),
                          bvh_impl="triton", active=act, interpret=True)
    _assert_same(got, ref)
    t = np.asarray(got[0])
    assert (t > 0).mean() > 0.3, "rays should mostly hit the mesh"
    if act is not None:   # inactive lanes never enter the meshes
        t_mesh = np.asarray(mesh_intersect_walk(
            scene, _vec(o), _vec(d), active=act, interpret=True)[0])
        assert (t_mesh[~np.asarray(act)] == -1.0).all()


def test_kernel_respects_t_bound():
    scene, _ = _soup_scene()
    o, d = _rays_at(scene, 200)
    free = mesh_intersect_walk(scene, _vec(o), _vec(d), interpret=True)
    t_free = np.asarray(free[0])
    assert (t_free > 0).sum() > 50
    # a bound just in front of every hit hides it; beyond it changes nothing
    bound = np.where(t_free > 0, t_free * 0.999, FLT_MAX).astype(np.float32)
    hidden = mesh_intersect_walk(scene, _vec(o), _vec(d),
                                 t_bound=jnp.asarray(bound), interpret=True)
    assert (np.asarray(hidden[0]) == -1.0).all()
    far = np.where(t_free > 0, t_free * 1.001, FLT_MAX).astype(np.float32)
    kept = mesh_intersect_walk(scene, _vec(o), _vec(d),
                               t_bound=jnp.asarray(far), interpret=True)
    np.testing.assert_array_equal(np.asarray(kept[0]), t_free)


@pytest.mark.parametrize("n", [1, 127, 128, 4097])
def test_wrapper_pads_any_pool_size(n):
    """Pools that are not a multiple of the block are padded with inactive
    lanes and sliced back; every real lane matches the jnp walk."""
    scene, geom_types = _soup_scene()
    o, d = _rays_at(scene, n)
    ref = intersect_scene(scene, geom_types, _vec(o), _vec(d),
                          bvh_impl="jnp")
    got = intersect_scene(scene, geom_types, _vec(o), _vec(d),
                          bvh_impl="triton", interpret=True)
    assert got[0].shape == (n,)
    _assert_same(got, ref)


def test_walk_closest_raw_outputs():
    """best_tri = -1 and t_min = t_bound on a miss; u, v are barycentrics."""
    scene, _ = _soup_scene()
    o, d = _rays_at(scene, BLOCK)
    n = o.shape[0]

    def walk(bound):
        return tuple(np.asarray(a) for a in walk_closest(
            scene.walk_nodes, scene.walk_tris, _vec(o), _vec(d),
            jnp.ones((n,), bool), jnp.full((n,), bound, jnp.float32),
            interpret=True))

    t_free = walk(FLT_MAX)[0]
    bound = np.float32(np.median(t_free[t_free < FLT_MAX]))
    t, tri, u, v = walk(bound)
    miss = tri < 0
    assert miss.any() and (~miss).any()
    assert (t[miss] == bound).all()
    assert (t[~miss] < bound).all()
    assert ((u[~miss] >= 0) & (v[~miss] >= 0) & (u[~miss] + v[~miss] <= 1)
            ).all()


def test_escape_links_forest():
    """Two trees in DFS order: a left child escapes to its sibling, a right
    child where its parent does, a root to the next root."""
    #        0            4
    #      1   2
    #          3 (only child chain: 2 -> 3 has no sibling)
    parent = np.array([-1, 0, 0, 2, -1])
    sibling = np.array([-1, 2, -1, -1, -1])
    np.testing.assert_array_equal(escape_links(parent, sibling),
                                  [4, 2, 4, 4, -1])


def test_pack_walk_tables_layout():
    scene, _ = _soup_scene(16)
    nodes = np.asarray(scene.walk_nodes).reshape(-1, 8)
    bvh = scene.bvh
    np.testing.assert_array_equal(nodes[:, 0].view(np.float32),
                                  np.asarray(bvh.min_x))
    np.testing.assert_array_equal(nodes[:, 5].view(np.float32),
                                  np.asarray(bvh.max_z))
    count = np.asarray(bvh.tri_count)
    leaf = count > 0
    np.testing.assert_array_equal(nodes[leaf, 6] & 255, count[leaf])
    np.testing.assert_array_equal(nodes[leaf, 6] >> 8,
                                  np.asarray(bvh.tri_first)[leaf])
    assert (nodes[~leaf, 6] == 0).all()
    tris = np.asarray(scene.walk_tris).reshape(-1, 9)
    tr = scene.triangles
    np.testing.assert_array_equal(tris[:, 3], np.asarray(tr.v1x)
                                  - np.asarray(tr.v0x))
    with pytest.raises(AssertionError, match="leaf too large"):
        pack_walk_tables(
            {"tri_count": np.array([256]), "tri_first": np.array([0]),
             "bounds_min": np.zeros((1, 3)), "bounds_max": np.zeros((1, 3)),
             "parent": np.array([-1]), "sibling": np.array([-1])},
            {"v0": np.zeros((1, 3)), "v1": np.zeros((1, 3)),
             "v2": np.zeros((1, 3))})


@pytest.mark.gpu
def test_compiled_kernel_matches_jnp_walk(gpu):
    """On the card: the Triton-compiled kernel against the XLA walk."""
    scene, settings = load_scene(scene_path("teapot"),
                                 overrides={"RES": [128, 128]})
    o, d = _rays_at(scene, 20000)
    ref = intersect_scene(scene, settings.geom_types, _vec(o), _vec(d),
                          bvh_impl="jnp")
    got = intersect_scene(scene, settings.geom_types, _vec(o), _vec(d),
                          bvh_impl="triton")
    t1, t2 = np.asarray(got[0]), np.asarray(ref[0])
    assert ((t1 > 0) == (t2 > 0)).mean() >= 0.9999
    both = (t1 > 0) & (t2 > 0)
    assert (np.abs(t1 - t2)[both] <= 1e-5 * t2[both]).mean() >= 0.9999
