"""Scene data model: flat SoA arrays, device-resident, pytree-registered.

This is the analogue of the reference's seven device buffers uploaded
in pathtraceInit (reference src/pathtrace.cu:143-233): geoms, materials, BVH
nodes, BVH triangles, plus camera parameters. Everything dynamic (differentiable
or device-resident) lives in NamedTuples (automatic pytrees); static shape-/
compile-relevant settings live in `RenderSettings` (hashable, passed as a static
argument to jit).

Geometry types follow reference src/sceneStructs.h:14-19.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

# GeomType enum (reference sceneStructs.h:14-19)
SPHERE = 0
CUBE = 1
MESH = 2

F32 = jnp.float32
I32 = jnp.int32


class GeomArrays(NamedTuple):
    """SoA of reference `Geom` (sceneStructs.h:27-39)."""

    gtype: jnp.ndarray             # [G] int32 in {SPHERE, CUBE, MESH}
    material_id: jnp.ndarray       # [G] int32
    transform: jnp.ndarray         # [G, 4, 4] f32
    inverse_transform: jnp.ndarray  # [G, 4, 4] f32
    inv_transpose: jnp.ndarray     # [G, 4, 4] f32
    root_node: jnp.ndarray         # [G] int32; BVH root for MESH, -1 otherwise

    @property
    def count(self) -> int:
        return self.gtype.shape[0]


class MaterialArrays(NamedTuple):
    """SoA of reference `Material` (sceneStructs.h:71-83). Differentiable leaves."""

    color: jnp.ndarray              # [M, 3] f32 (albedo)
    specular_color: jnp.ndarray     # [M, 3] f32
    specular_exponent: jnp.ndarray  # [M] f32
    has_reflective: jnp.ndarray     # [M] f32 (1 - roughness)
    has_refractive: jnp.ndarray     # [M] f32 (1 - transparency)
    ior: jnp.ndarray                # [M] f32
    emittance: jnp.ndarray          # [M] f32

    @property
    def count(self) -> int:
        return self.emittance.shape[0]


class BVHArrays(NamedTuple):
    """SoA of reference `LinearBVHNode` (sceneStructs.h:55-59).

    Depth-first layout: node i's left child is i+1; right child at
    `second_child[i]`. Leaf iff tri_count[i] > 0 (up to max_leaf contiguous
    triangles per leaf — see scene/bvh.py). Bounds are fully component-split
    ([N] per component); parent/sibling links drive the stackless walk.
    """

    min_x: jnp.ndarray  # [N] f32
    min_y: jnp.ndarray
    min_z: jnp.ndarray
    max_x: jnp.ndarray
    max_y: jnp.ndarray
    max_z: jnp.ndarray
    tri_first: jnp.ndarray     # [N] int32, -1 for interior
    tri_count: jnp.ndarray     # [N] int32, 0 for interior
    second_child: jnp.ndarray  # [N] int32
    parent: jnp.ndarray        # [N] int32, -1 at root (stackless traversal)
    sibling: jnp.ndarray       # [N] int32, right sibling of a left child


class TriangleArrays(NamedTuple):
    """SoA of reference `TriangleVerts` (sceneStructs.h:61-69), world-space
    baked, fully component-split for 1-D gathers: 18 coordinate arrays [T]."""

    v0x: jnp.ndarray
    v0y: jnp.ndarray
    v0z: jnp.ndarray
    v1x: jnp.ndarray
    v1y: jnp.ndarray
    v1z: jnp.ndarray
    v2x: jnp.ndarray
    v2y: jnp.ndarray
    v2z: jnp.ndarray
    n0x: jnp.ndarray
    n0y: jnp.ndarray
    n0z: jnp.ndarray
    n1x: jnp.ndarray
    n1y: jnp.ndarray
    n1z: jnp.ndarray
    n2x: jnp.ndarray
    n2y: jnp.ndarray
    n2z: jnp.ndarray
    material_id: jnp.ndarray  # [T] int32

    def vertex(self, name: str, idx: jnp.ndarray):
        """Gather one corner/normal as a Vec3 of [N] (name in v0..n2)."""
        from ..utils.vec import Vec3
        return Vec3(getattr(self, name + "x")[idx],
                    getattr(self, name + "y")[idx],
                    getattr(self, name + "z")[idx])


class CameraArrays(NamedTuple):
    """Dynamic camera parameters (reference sceneStructs.h:85-97).

    Resolution is static (it sets array shapes) and lives in RenderSettings.
    These are differentiable: gradients w.r.t. position/view/lens params flow
    through ray generation.
    """

    position: jnp.ndarray        # [3]
    view: jnp.ndarray            # [3]
    up: jnp.ndarray              # [3]
    right: jnp.ndarray           # [3]
    pixel_length: jnp.ndarray    # [2]
    lens_radius: jnp.ndarray     # [] scalar
    focal_distance: jnp.ndarray  # [] scalar


class SceneArrays(NamedTuple):
    """Everything the device needs — the analogue of pathtraceInit's uploads."""

    geoms: GeomArrays
    materials: MaterialArrays
    bvh: BVHArrays
    triangles: TriangleArrays
    camera: CameraArrays
    # GPU kernel tables (ops/bvh_walk.py pack_walk_tables): one 32-byte
    # record per node and (v0, e1, e2) per triangle, in global memory
    walk_nodes: jnp.ndarray    # [N * 8] i32
    walk_tris: jnp.ndarray     # [T * 9] f32


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static, hashable render configuration.

    Replaces the reference's compile-time #define matrix (pathtrace.cu:26-42)
    and the scene JSON's camera block statics (scene.cpp:225-230).
    """

    width: int
    height: int
    trace_depth: int = 8
    iterations: int = 5000
    image_name: str = "render"
    jitter: bool = True          # JITTER: Gaussian AA, sigma=0.005, clamp +-0.5
    dof: bool = True             # DOF: thin-lens, active iff lens_radius > 0
    sort_materials: bool = False  # COALESCED: material-key sort each bounce
    # STREAM_COMPACT ablation mode (tile-granular work skipping); opt-in,
    # not yet measured against masked lanes on the GPU (engine/wavefront.py)
    compact: bool = False
    compact_tile: int = 16384    # lanes per skippable tile (compact mode)
    fast_rng: bool = True        # PCG hash streams (vs jax threefry); see ops/rng.py
    # Material-table capability flags (set by the loader): BSDF branches no
    # material can take are not built at trace time (ops/bsdf.py scatter_ray).
    any_glossy: bool = True
    any_refractive: bool = True
    # Reference termination quirk (SURVEY.md §3.2c): depth-truncated paths
    # contribute raw throughput. Default False = textbook termination, which
    # matches the reference's own golden render (see ops/bsdf.py shade).
    depth_quirk: bool = False
    # Russian-roulette throughput termination from this bounce depth on
    # (0 = off, the reference's behavior; its README lists RR as future work).
    rr_start: int = 0
    # mesh intersector (ops/intersect.py BVH_IMPLS): "triton" the GPU kernel
    # (ops/bvh_walk.py), "jnp" the stackless walk in plain XLA. The loader
    # picks by platform (scene/loader.py default_bvh_impl).
    bvh_impl: str = "jnp"
    # run Pallas kernels in the interpreter (CPU tests only; never derived
    # from the backend)
    interpret: bool = False
    look_at: tuple = (0.0, 0.0, 0.0)  # for orbit-camera controls (viewer)
    fovy_deg: float = 45.0
    # Static per-geom type tuple (SPHERE/CUBE/MESH): lets the trace-time geom
    # loop unroll per type so XLA fuses all analytic tests into one pass.
    geom_types: tuple = ()
    # Tile-major lane order (tile_h, tile_w), or None for scanline order.
    # Images are IDENTICAL either way (RNG and estimators are keyed by pixel
    # id); tiling only changes which rays share a traversal-kernel block.
    tile: tuple | None = None
    # Round-robin shard interleave (set by parallel/sharding wrappers to the
    # shard count S): before the tile map, shard s's contiguous lane block
    # is re-dealt over every-S-th GRANULE (~1k consecutive base lanes) of
    # the image instead of one contiguous band. Spatially decorrelated
    # shards equalize per-shard path work — measured on the 8-virtual-device
    # mesh: contiguous bands were 1.18x max/mean bounce work on cornell and
    # 1.65x on the open scene (parallel/sharding.shard_work_counts).
    # Granules (not single lanes) keep intra-shard kernel blocks spatially
    # coherent for the mesh intersectors. Images are IDENTICAL (RNG keyed
    # by pixel id; lanes_to_image inverts the composed map).
    shard_interleave: int | None = None

    def pixel_map(self):
        """lane -> pixel id function (identity when untiled)."""
        if self.tile is None:
            base = lambda lane: lane
        else:
            from ..ops.camera import tile_pixel_map
            base = tile_pixel_map(self.width, self.height, *self.tile)
        S = self.shard_interleave
        if not S or S <= 1:
            return base
        n_local = self.pixel_count // S
        # >=32 granules per shard for averaging, capped at ~1k lanes per
        # granule for intra-shard block coherence
        G = _granule(n_local, target=max(64, min(1024, n_local // 32)))

        def m(lane):
            l, s = lane % n_local, lane // n_local
            q, r = l // G, l % G
            return base((q * S + s) * G + r)

        return m

    @property
    def pixel_count(self) -> int:
        return self.width * self.height


def _granule(n_local: int, target: int = 1024) -> int:
    """Largest divisor of n_local <= target: the shard-interleave granule.

    ~1k consecutive base lanes per granule keeps kernel blocks spatially
    coherent while giving each shard n_local/G spread granules to average
    work over (800x800 / 8 shards -> G=1000, 80 granules per shard)."""
    best = 1
    d = 1
    while d * d <= n_local:
        if n_local % d == 0:
            if d <= target:
                best = max(best, d)
            q = n_local // d
            if q <= target:
                best = max(best, q)
        d += 1
    return best


def _pad4(m: np.ndarray) -> np.ndarray:
    return np.asarray(m, dtype=np.float32)


def make_scene_arrays(
    geom_list, material_list, bvh_nodes, bvh_tris, camera
) -> SceneArrays:
    """Build device SceneArrays from host-side Python lists/dicts (see loader)."""
    g = len(geom_list)
    geoms = GeomArrays(
        gtype=jnp.asarray([x["type"] for x in geom_list], dtype=I32),
        material_id=jnp.asarray([x["material_id"] for x in geom_list], dtype=I32),
        transform=jnp.asarray(
            np.stack([_pad4(x["transform"]) for x in geom_list]), dtype=F32
        ),
        inverse_transform=jnp.asarray(
            np.stack([_pad4(x["inverse_transform"]) for x in geom_list]), dtype=F32
        ),
        inv_transpose=jnp.asarray(
            np.stack([_pad4(x["inv_transpose"]) for x in geom_list]), dtype=F32
        ),
        root_node=jnp.asarray([x.get("root_node", -1) for x in geom_list], dtype=I32),
    )
    assert g > 0, "scene must have at least one geom"

    m = len(material_list)
    assert m > 0, "scene must have at least one material"

    def mat_field(key, default, dim=None):
        if dim is None:
            return jnp.asarray(
                [x.get(key, default) for x in material_list], dtype=F32
            )
        return jnp.asarray(
            np.array([x.get(key, default) for x in material_list], dtype=np.float32)
        )

    materials = MaterialArrays(
        color=mat_field("color", (0.0, 0.0, 0.0), dim=3),
        specular_color=mat_field("specular_color", (0.0, 0.0, 0.0), dim=3),
        specular_exponent=mat_field("specular_exponent", 0.0),
        has_reflective=mat_field("has_reflective", 0.0),
        has_refractive=mat_field("has_refractive", 0.0),
        ior=mat_field("ior", 0.0),
        emittance=mat_field("emittance", 0.0),
    )

    # Never-empty BVH/triangle buffers: keep one degenerate node so shapes are
    # static and non-zero even for meshless scenes (XLA needs static shapes).
    if bvh_nodes is None or len(bvh_nodes["bounds_min"]) == 0:
        inf = np.float32(np.inf)
        bvh_nodes = {
            "bounds_min": np.full((1, 3), inf, np.float32),
            "bounds_max": np.full((1, 3), -inf, np.float32),
            "tri_first": np.full((1,), -1, np.int32),
            "tri_count": np.zeros((1,), np.int32),
            "second_child": np.zeros((1,), np.int32),
            "parent": np.full((1,), -1, np.int32),
            "sibling": np.full((1,), -1, np.int32),
        }
        z = np.zeros((1, 3), np.float32)
        bvh_tris = {"v0": z, "v1": z, "v2": z, "n0": z, "n1": z, "n2": z,
                    "material_id": np.zeros((1,), np.int32)}
    bmin = np.asarray(bvh_nodes["bounds_min"], dtype=np.float32)
    bmax = np.asarray(bvh_nodes["bounds_max"], dtype=np.float32)
    bvh = BVHArrays(
        min_x=jnp.asarray(bmin[:, 0]), min_y=jnp.asarray(bmin[:, 1]),
        min_z=jnp.asarray(bmin[:, 2]), max_x=jnp.asarray(bmax[:, 0]),
        max_y=jnp.asarray(bmax[:, 1]), max_z=jnp.asarray(bmax[:, 2]),
        tri_first=jnp.asarray(bvh_nodes["tri_first"], dtype=I32),
        tri_count=jnp.asarray(bvh_nodes["tri_count"], dtype=I32),
        second_child=jnp.asarray(bvh_nodes["second_child"], dtype=I32),
        parent=jnp.asarray(bvh_nodes["parent"], dtype=I32),
        sibling=jnp.asarray(bvh_nodes["sibling"], dtype=I32),
    )
    comps = []
    for name in ("v0", "v1", "v2", "n0", "n1", "n2"):
        arr = np.asarray(bvh_tris[name], dtype=np.float32)
        comps.extend([jnp.asarray(arr[:, 0]), jnp.asarray(arr[:, 1]),
                      jnp.asarray(arr[:, 2])])
    tris = TriangleArrays(
        *comps, material_id=jnp.asarray(bvh_tris["material_id"], dtype=I32))
    from ..ops.bvh_walk import pack_walk_tables   # ops imports this module
    walk_nodes, walk_tris = pack_walk_tables(bvh_nodes, bvh_tris)

    cam = CameraArrays(
        position=jnp.asarray(camera["position"], dtype=F32),
        view=jnp.asarray(camera["view"], dtype=F32),
        up=jnp.asarray(camera["up"], dtype=F32),
        right=jnp.asarray(camera["right"], dtype=F32),
        pixel_length=jnp.asarray(camera["pixel_length"], dtype=F32),
        lens_radius=jnp.asarray(camera["lens_radius"], dtype=F32),
        focal_distance=jnp.asarray(camera["focal_distance"], dtype=F32),
    )
    return SceneArrays(geoms=geoms, materials=materials, bvh=bvh,
                       triangles=tris, camera=cam,
                       walk_nodes=jnp.asarray(walk_nodes),
                       walk_tris=jnp.asarray(walk_tris))
