"""Scene loader tests: JSON material mapping, camera derivation, transforms
(reference semantics, src/scene.cpp:42-259)."""
import json
import os

import numpy as np
import pytest

from pathtracer_tpu import load_scene
from pathtracer_tpu.scene.loader import apply_initial_orbit, derive_camera
from pathtracer_tpu.scene.types import CUBE, MESH, SPHERE
from pathtracer_tpu.utils.math import build_transformation_matrix


def test_build_transformation_matrix_trs_order():
    # T * Rx * Ry * Rz * S with degrees (utilities.cpp:85-93)
    m = build_transformation_matrix((1, 2, 3), (0, 90, 0), (2, 2, 2))
    # unit x scaled by 2, rotated 90 deg about y (x -> -z), translated
    p = m @ np.array([1.0, 0.0, 0.0, 1.0])
    np.testing.assert_allclose(p[:3], [1, 2, 3 - 2], atol=1e-12)


def test_material_mapping(tmp_path):
    scene_json = {
        "Materials": {
            "d": {"TYPE": "Diffuse", "RGB": [0.1, 0.2, 0.3]},
            "e": {"TYPE": "Emitting", "RGB": [1, 1, 1], "EMITTANCE": 5.0},
            "s": {"TYPE": "Specular", "RGB": [0.9, 0.9, 0.9],
                  "ROUGHNESS": 0.3},
            "r": {"TYPE": "Refractive", "RGB": [1, 1, 1],
                  "TRANSPARENCY": 0.25, "IOR": 1.33},
            "r2": {"TYPE": "Refractive", "RGB": [0.2, 0.2, 0.7],
                   "SPECULAR_COLOR": [0.3, 0.3, 0.8], "ROUGHNESS": 0.2},
        },
        "Camera": {"RES": [32, 32], "FOVY": 45.0, "ITERATIONS": 4,
                   "DEPTH": 4, "FILE": "t", "EYE": [0, 5, 10.5],
                   "LOOKAT": [0, 5, 0], "UP": [0, 1, 0]},
        "Objects": [
            {"TYPE": "cube", "MATERIAL": "d", "TRANS": [0, 0, 0],
             "ROTAT": [0, 0, 0], "SCALE": [1, 1, 1]},
            {"TYPE": "sphere", "MATERIAL": "s", "TRANS": [0, 1, 0],
             "ROTAT": [0, 0, 0], "SCALE": [1, 1, 1]},
        ],
    }
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(scene_json))
    scene, settings = load_scene(str(p))

    mats = scene.materials
    # Diffuse
    np.testing.assert_allclose(np.asarray(mats.color[0]), [0.1, 0.2, 0.3])
    assert float(mats.has_reflective[0]) == 0.0
    # Emitting
    assert float(mats.emittance[1]) == 5.0
    # Specular: has_reflective = 1 - roughness; spec color defaults to RGB
    assert float(mats.has_reflective[2]) == pytest.approx(0.7)
    np.testing.assert_allclose(np.asarray(mats.specular_color[2]),
                               [0.9, 0.9, 0.9])
    # Refractive: 1 - transparency; IOR; also reflective from roughness
    assert float(mats.has_refractive[3]) == pytest.approx(0.75)
    assert float(mats.ior[3]) == pytest.approx(1.33)
    assert float(mats.has_reflective[3]) == pytest.approx(1.0)
    # Refractive defaults: IOR 1.5, explicit specular color
    assert float(mats.ior[4]) == pytest.approx(1.5)
    np.testing.assert_allclose(np.asarray(mats.specular_color[4]),
                               [0.3, 0.3, 0.8])

    assert settings.geom_types == (CUBE, SPHERE)
    assert settings.width == 32 and settings.trace_depth == 4


def test_camera_derivation_reference_quirk():
    # pixelLength uses tan(fovy * pi/180) of the FULL angle (scene.cpp:239-248)
    cam = derive_camera((0, 5, 10.5), (0, 5, 0), (0, 1, 0), 45.0, 800, 800,
                        10.0, 0.0)
    yscaled = np.tan(45.0 * np.pi / 180.0)
    assert cam["pixel_length"][1] == pytest.approx(2 * yscaled / 800)
    np.testing.assert_allclose(cam["view"], [0, 0, -1], atol=1e-12)
    np.testing.assert_allclose(cam["right"], [1, 0, 0], atol=1e-12)  # cross(view, up)


def test_initial_orbit_matches_loaded_camera_for_y_up():
    # For axis-aligned scenes the orbit rebuild reproduces the same camera
    # (main.cpp:359-381,423-441)
    cam = derive_camera((0, 5, 10.5), (0, 5, 0), (0, 1, 0), 45.0, 800, 800,
                        10.0, 0.0)
    orb = apply_initial_orbit(cam)
    np.testing.assert_allclose(orb["position"], cam["position"], atol=1e-6)
    np.testing.assert_allclose(orb["view"], cam["view"], atol=1e-6)
    np.testing.assert_allclose(orb["up"], [0, 1, 0], atol=1e-6)


def test_cornell_loads(cornell_small):
    scene, settings = cornell_small
    assert settings.geom_types == (CUBE,) * 6 + (SPHERE,)
    assert scene.materials.count == 5
    # light is material 0 with emittance 5
    assert float(scene.materials.emittance[0]) == 5.0
    # camera: lens radius 0.2 from the scene file
    assert float(scene.camera.lens_radius) == pytest.approx(0.2)


@pytest.mark.skipif(False,
                    reason="reference scenes unavailable")
def test_teapot_mesh_loads():
    from pathtracer_tpu.scene.fixtures import scene_path
    scene, settings = load_scene(scene_path("teapot"),
                                 overrides={"RES": [32, 32]})
    assert MESH in settings.geom_types
    leaf = np.asarray(scene.bvh.tri_count) > 0
    # true triangle count (the array is padded for row-aligned leaves)
    assert np.asarray(scene.bvh.tri_count)[leaf].sum() == 6320


@pytest.mark.skipif(False,
                    reason="reference scenes unavailable")
def test_alien_mesh_with_mtl_loads():
    """alienanimal.obj + .mtl: per-face MTL materials are appended to the
    material table (scene.cpp:289-314 semantics)."""
    from pathtracer_tpu.scene.fixtures import scene_path
    scene, settings = load_scene(scene_path("animal"),
                                 overrides={"RES": [32, 32]})
    # true triangle count (the array is padded for row-aligned leaves)
    leaf = np.asarray(scene.bvh.tri_count) > 0
    assert np.asarray(scene.bvh.tri_count)[leaf].sum() == 46588
    # MTL materials beyond the JSON-declared ones
    assert scene.materials.count > 2
    # every triangle has a valid material id
    mids = np.asarray(scene.triangles.material_id)
    assert (mids >= 0).all() and (mids < scene.materials.count).all()


def test_two_meshes_offset_fixup(tmp_path):
    """Two mesh objects in one scene: node/triangle global offset fix-up
    (scene.cpp:178-189) must keep each BVH self-consistent, and both meshes
    must be hittable."""
    import json

    import jax.numpy as jnp

    from pathtracer_tpu.ops.intersect import intersect_scene
    from pathtracer_tpu.utils.vec import Vec3

    # two unit quads (2 tris each) at z=-2 (left) and z=-4 (right)
    obj = """
v -1 -1 0
v 1 -1 0
v 1 1 0
v -1 1 0
f 1 2 3
f 1 3 4
"""
    p = tmp_path / "quad.obj"
    p.write_text(obj)
    scene_json = {
        "Materials": {
            "white": {"TYPE": "Diffuse", "RGB": [0.9, 0.9, 0.9]},
            "red": {"TYPE": "Diffuse", "RGB": [0.9, 0.1, 0.1]},
        },
        "Camera": {
            "RES": [16, 16], "FOVY": 45.0, "ITERATIONS": 1, "DEPTH": 2,
            "FILE": "x", "EYE": [0, 0, 5], "LOOKAT": [0, 0, 0],
            "UP": [0, 1, 0],
        },
        "Objects": [
            {"TYPE": "mesh", "FILE": str(p), "MATERIAL": "white",
             "TRANS": [-1.5, 0, -2], "ROTAT": [0, 0, 0], "SCALE": [1, 1, 1]},
            {"TYPE": "mesh", "FILE": str(p), "MATERIAL": "red",
             "TRANS": [1.5, 0, -4], "ROTAT": [0, 0, 0], "SCALE": [1, 1, 1]},
        ],
    }
    jp = tmp_path / "two.json"
    jp.write_text(json.dumps(scene_json))
    scene, settings = load_scene(str(jp), orbit=False)
    assert settings.geom_types == (2, 2)
    leaf = np.asarray(scene.bvh.tri_count) > 0
    assert np.asarray(scene.bvh.tri_count)[leaf].sum() == 4
    roots = np.asarray(scene.geoms.root_node)
    assert roots[0] == 0 and roots[1] == 3  # 3 nodes per 2-tri mesh

    o = Vec3(jnp.asarray([-1.5, 1.5]), jnp.asarray([0.0, 0.0]),
             jnp.asarray([5.0, 5.0]))
    d = Vec3(jnp.asarray([0.0, 0.0]), jnp.asarray([0.0, 0.0]),
             jnp.asarray([-1.0, -1.0]))
    t, nrm, mat = intersect_scene(scene, settings.geom_types, o, d,
                                  bvh_impl="jnp")
    assert abs(float(t[0]) - 7.0) < 1e-3   # left quad at z=-2
    assert abs(float(t[1]) - 9.0) < 1e-3   # right quad at z=-4
    assert int(mat[0]) == 0 and int(mat[1]) == 1

    # the GPU kernel agrees (interpret mode on CPU): one walk over the
    # forest, roots chained by escape links
    t2, _, mat2 = intersect_scene(scene, settings.geom_types, o, d,
                                  bvh_impl="triton", interpret=True)
    np.testing.assert_allclose(np.asarray(t), np.asarray(t2), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(mat), np.asarray(mat2))
