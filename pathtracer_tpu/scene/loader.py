"""JSON scene loader, matching reference src/scene.cpp:42-259 semantics.

Material type mapping (scene.cpp:47-128):
  Diffuse:    color=RGB
  Emitting:   color=RGB, emittance=EMITTANCE
  Specular:   color=RGB, has_reflective = 1 - clamp(ROUGHNESS,0,1),
              specular_color = SPECULAR_COLOR or RGB, exponent or 0
  Refractive: color=RGB, has_refractive = 1 - clamp(TRANSPARENCY,0,1),
              ior = IOR or 1.5, has_reflective = 1 - clamp(ROUGHNESS,0,1),
              specular_color = SPECULAR_COLOR or RGB

Camera derivation (scene.cpp:238-253): pixel_length = 2*scaled/res with
yscaled = tan(fovy_deg * pi/180)  [reference quirk: degrees*(PI/180) applied to
the FULL fovy, not fovy/2 — replicated for parity].

`apply_initial_orbit` replicates the startup camera recompute in the reference
app (main.cpp:359-381 spherical derivation + main.cpp:423-441 rebuild), which
runs before the first frame because camchanged=true (main.cpp:36).
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from ..utils.math import PI, build_transformation_matrix, inverse_transpose, normalize
from . import obj as obj_loader
from .bvh import build_bvh
from .types import CUBE, MESH, SPHERE, RenderSettings, SceneArrays, make_scene_arrays

# triangles per BVH leaf for every mesh, swept on the H100 over {1, 2, 4, 8}
# (PERF.md, tools/walk_sweep.py): 1, the reference's own (bvhnode.cpp:
# 165-169), gave the fastest teapot and alien frames
MAX_LEAF = 1

# mesh traversal per JAX platform (ops/intersect.py BVH_IMPLS)
BVH_IMPL_BY_PLATFORM = {"gpu": "triton", "cpu": "jnp"}


def default_bvh_impl(platform: Optional[str] = None) -> str:
    """The mesh traversal for `platform` (default: JAX's default backend):
    the GPU kernel on "gpu", the plain-XLA walk on "cpu". Any other platform
    has no mesh traversal and raises."""
    if platform is None:
        import jax
        platform = jax.default_backend()
    try:
        return BVH_IMPL_BY_PLATFORM[platform]
    except KeyError:
        raise RuntimeError(
            f"no mesh traversal for platform {platform!r}; supported: "
            f"{sorted(BVH_IMPL_BY_PLATFORM)}") from None


def _parse_material(p: dict) -> dict:
    m = {
        "color": (0.0, 0.0, 0.0),
        "specular_color": (0.0, 0.0, 0.0),
        "specular_exponent": 0.0,
        "has_reflective": 0.0,
        "has_refractive": 0.0,
        "ior": 0.0,
        "emittance": 0.0,
    }
    t = p["TYPE"]
    rgb = tuple(float(x) for x in p["RGB"])
    m["color"] = rgb
    if t == "Diffuse":
        pass
    elif t == "Emitting":
        m["emittance"] = float(p["EMITTANCE"])
    elif t == "Specular":
        roughness = float(np.clip(p.get("ROUGHNESS", 0.0), 0.0, 1.0))
        m["has_reflective"] = 1.0 - roughness
        m["specular_color"] = tuple(float(x) for x in p.get("SPECULAR_COLOR", rgb))
        m["specular_exponent"] = float(p.get("SPECULAR_EXPONENT", 0.0))
    elif t == "Refractive":
        transparency = float(np.clip(p.get("TRANSPARENCY", 0.0), 0.0, 1.0))
        m["has_refractive"] = 1.0 - transparency
        m["ior"] = float(p.get("IOR", 1.5))
        roughness = float(np.clip(p.get("ROUGHNESS", 0.0), 0.0, 1.0))
        m["has_reflective"] = 1.0 - roughness
        m["specular_color"] = tuple(float(x) for x in p.get("SPECULAR_COLOR", rgb))
        m["specular_exponent"] = float(p.get("SPECULAR_EXPONENT", 0.0))
    else:
        raise ValueError(f"unknown material TYPE {t!r}")
    return m


def derive_camera(eye, look_at, up, fovy_deg: float, width: int, height: int,
                  focal_distance: float, lens_radius: float) -> dict:
    """Camera vector/pixel-length derivation (scene.cpp:238-253)."""
    position = np.asarray(eye, dtype=np.float64)
    look_at = np.asarray(look_at, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    yscaled = np.tan(fovy_deg * (PI / 180.0))
    xscaled = (yscaled * width) / height
    view = normalize(look_at - position)
    right = normalize(np.cross(view, up))
    pixel_length = (2.0 * xscaled / float(width), 2.0 * yscaled / float(height))
    return {
        "position": position,
        "view": view,
        "up": up,
        "right": right,
        "pixel_length": pixel_length,
        "focal_distance": focal_distance,
        "lens_radius": lens_radius,
        "look_at": look_at,
    }


def apply_initial_orbit(cam: dict) -> dict:
    """Replicate the reference app's startup orbit-camera rebuild.

    main.cpp:359-381 derives (phi, theta, zoom) from the loaded view vector,
    then main.cpp:423-441 rebuilds position/view/up/right from them before the
    first frame (camchanged starts true). Note up/right are unnormalized cross
    products in the reference; replicated as-is.
    """
    view = np.asarray(cam["view"], dtype=np.float64)
    look_at = np.asarray(cam["look_at"], dtype=np.float64)
    zoom = float(np.linalg.norm(np.asarray(cam["position"]) - look_at))
    view_xz = np.array([view[0], 0.0, view[2]])
    view_zy = np.array([0.0, view[1], view[2]])
    phi = float(np.arccos(np.clip(np.dot(normalize(view_xz), [0, 0, -1]), -1, 1)))
    theta = float(np.arccos(np.clip(np.dot(normalize(view_zy), [0, 1, 0]), -1, 1)))
    return orbit_camera(cam, zoom, theta, phi, look_at)


def orbit_camera(cam: dict, zoom: float, theta: float, phi: float,
                 look_at: np.ndarray) -> dict:
    """Rebuild camera from spherical coords (main.cpp:423-441)."""
    offset = np.array([
        zoom * np.sin(phi) * np.sin(theta),
        zoom * np.cos(theta),
        zoom * np.cos(phi) * np.sin(theta),
    ])
    v = -normalize(offset)
    u = np.array([0.0, 1.0, 0.0])
    r = np.cross(v, u)          # unnormalized, as in reference
    new_up = np.cross(r, v)     # unnormalized, as in reference
    out = dict(cam)
    out["position"] = offset + look_at
    out["view"] = v
    out["up"] = new_up
    out["right"] = r
    out["look_at"] = look_at
    return out


def load_scene(path: str, orbit: bool = True,
               overrides: Optional[dict] = None
               ) -> Tuple[SceneArrays, RenderSettings]:
    """Load a scene JSON; returns (device arrays, static settings).

    `orbit=True` applies the reference app's startup camera rebuild (the camera
    actually used for its published renders). `overrides` patches camera-block
    values (e.g. {"RES": [256,256], "ITERATIONS": 64}) for small test configs.
    Every mesh gets a SAH BVH with MAX_LEAF triangles per leaf; the mesh
    traversal follows JAX's platform (default_bvh_impl)."""
    with open(path, "r") as f:
        data = json.load(f)

    materials = []
    mat_name_to_id = {}
    for name, p in data["Materials"].items():
        mat_name_to_id[name] = len(materials)
        materials.append(_parse_material(p))

    scene_dir = os.path.dirname(os.path.abspath(path))

    geoms = []
    all_nodes = {"bounds_min": [], "bounds_max": [], "tri_first": [],
                 "tri_count": [], "second_child": [], "parent": [],
                 "sibling": []}
    all_tris = {k: [] for k in ("v0", "v1", "v2", "n0", "n1", "n2", "material_id")}
    node_count = 0
    tri_count = 0
    mesh_id = 0

    for p in data["Objects"]:
        t = p["TYPE"]
        if t == "mesh":
            obj_file = p["FILE"]
            # Reference resolves FILE relative to the process CWD (repo root);
            # we try as-given, then relative to the scene file, then relative
            # to the scene file's parent (to mimic "scenes/models/x.obj").
            candidates = [
                obj_file,
                os.path.join(scene_dir, obj_file),
                os.path.join(os.path.dirname(scene_dir), obj_file),
                os.path.join(scene_dir, os.path.basename(obj_file)),
                os.path.join(scene_dir, "models", os.path.basename(obj_file)),
            ]
            resolved = next((c for c in candidates if os.path.exists(c)), None)
            if resolved is None:
                raise FileNotFoundError(f"mesh file {obj_file!r} not found")
            override_id = mat_name_to_id[p["MATERIAL"]] if "MATERIAL" in p else -1
            trans = p.get("TRANS", (0.0, 0.0, 0.0))
            rotat = p.get("ROTAT", (0.0, 0.0, 0.0))
            scal = p.get("SCALE", (1.0, 1.0, 1.0))
            tris = obj_loader.load_obj(resolved, override_id, trans, rotat, scal,
                                       materials)
            nodes, reordered = build_bvh(tris, max_leaf=MAX_LEAF)
            # Global offset fix-up (scene.cpp:178-189)
            n_new = nodes["tri_first"].shape[0]
            is_leaf = nodes["tri_count"] > 0
            fixed_tri = np.where(is_leaf, nodes["tri_first"] + tri_count, -1)
            fixed_sc = np.where(is_leaf, nodes["second_child"],
                                nodes["second_child"] + node_count)
            fixed_par = np.where(nodes["parent"] >= 0,
                                 nodes["parent"] + node_count, -1)
            fixed_sib = np.where(nodes["sibling"] >= 0,
                                 nodes["sibling"] + node_count, -1)
            all_nodes["bounds_min"].append(nodes["bounds_min"])
            all_nodes["bounds_max"].append(nodes["bounds_max"])
            all_nodes["tri_first"].append(fixed_tri.astype(np.int32))
            all_nodes["tri_count"].append(nodes["tri_count"].astype(np.int32))
            all_nodes["second_child"].append(fixed_sc.astype(np.int32))
            all_nodes["parent"].append(fixed_par.astype(np.int32))
            all_nodes["sibling"].append(fixed_sib.astype(np.int32))
            for k in all_tris:
                all_tris[k].append(reordered[k])
            geoms.append({
                "type": MESH,
                "material_id": override_id if override_id >= 0 else 0,
                "transform": np.eye(4, dtype=np.float32),
                "inverse_transform": np.eye(4, dtype=np.float32),
                "inv_transpose": np.eye(4, dtype=np.float32),
                "root_node": node_count,
            })
            node_count += n_new
            tri_count += reordered["v0"].shape[0]
            mesh_id += 1
            continue

        gtype = CUBE if t == "cube" else SPHERE
        tf = build_transformation_matrix(p["TRANS"], p["ROTAT"], p["SCALE"])
        geoms.append({
            "type": gtype,
            "material_id": mat_name_to_id[p["MATERIAL"]],
            "transform": tf,
            "inverse_transform": np.linalg.inv(tf),
            "inv_transpose": inverse_transpose(tf),
            "root_node": -1,
        })

    cam_data = dict(data["Camera"])
    if overrides:
        cam_data.update(overrides)
    width, height = int(cam_data["RES"][0]), int(cam_data["RES"][1])
    fovy = float(cam_data["FOVY"])
    cam = derive_camera(
        cam_data["EYE"], cam_data["LOOKAT"], cam_data["UP"], fovy, width, height,
        focal_distance=float(cam_data.get("FOCAL_DISTANCE", 10.0)),
        lens_radius=float(cam_data.get("LENS_RADIUS", 0.0)),
    )
    if orbit:
        cam = apply_initial_orbit(cam)

    from ..ops.camera import pick_tile
    settings = RenderSettings(
        width=width,
        height=height,
        # tile-major lane order groups neighbouring pixels into one kernel
        # block (mesh traversal coherence); meshless scenes skip its index
        # math
        tile=pick_tile(width, height) if node_count else None,
        bvh_impl=default_bvh_impl(),
        any_glossy=any(m["has_reflective"] != 0.0 and m["has_refractive"] == 0.0
                       for m in materials),
        any_refractive=any(m["has_refractive"] != 0.0 for m in materials),
        trace_depth=int(cam_data["DEPTH"]),
        iterations=int(cam_data["ITERATIONS"]),
        image_name=str(cam_data.get("FILE", "render")),
        look_at=tuple(float(x) for x in cam_data["LOOKAT"]),
        fovy_deg=fovy,
        geom_types=tuple(int(g["type"]) for g in geoms),
    )

    if node_count:
        bvh_nodes = {k: np.concatenate(v, axis=0) for k, v in all_nodes.items()}
        bvh_tris = {k: np.concatenate(v, axis=0) for k, v in all_tris.items()}
    else:
        bvh_nodes, bvh_tris = None, None

    arrays = make_scene_arrays(geoms, materials, bvh_nodes, bvh_tris, cam)
    return arrays, settings
