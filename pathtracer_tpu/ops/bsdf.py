"""BSDF sampling and the uber-shader, vectorized as select trees (Vec3 SoA).

Replicates reference src/interactions.cu (scatterRay and helpers) and the
uber shading kernel shadeRealMaterial (src/pathtrace.cu:524-571). Termination:
  (a) hit emitter  -> color *= albedo*emittance, terminate
  (b) miss         -> color = background black, terminate
  (c) depth exhausted -> contributes NOTHING by default (textbook; matches
      the reference's checked-in golden render). The CURRENT reference code
      instead accumulates the raw throughput (gatherImage quirk,
      pathtrace.cu:574-589, SURVEY.md §3.2c) — opt in via depth_quirk.

All branches are computed for every lane and combined with selects — the
data-parallel form of the reference's warp-divergent uber-kernel. Sampling is
reparameterized on explicit uniforms so jax.grad flows through the continuous
paths (albedo/specular/emittance/IOR) with branch decisions held fixed.

Material parameters arrive as per-lane gathers; for the small material tables
typical of scenes (M <= ~32) the gather is unrolled into a select chain that
XLA fuses into the shading pass.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..scene.types import MaterialArrays
from ..utils.math import SQRT_OF_ONE_THIRD, TWO_PI
from ..utils.vec import Vec3

SCATTER_EPS = 1e-3  # interactions.cu:61
LUMA_R, LUMA_G, LUMA_B = 0.2126, 0.7152, 0.0722  # interactions.cu:75-76
# Unroll material lookup as a select chain below this table size.
MATERIAL_SELECT_MAX = 32


def cosine_hemisphere(normal: Vec3, u1: jnp.ndarray, u2: jnp.ndarray) -> Vec3:
    """Cosine-weighted hemisphere sample around `normal`
    (calculateRandomDirectionInHemisphere, interactions.cu:7-45)."""
    up = jnp.sqrt(u1)
    over = jnp.sqrt(jnp.maximum(1.0 - up * up, 0.0))
    around = u2 * TWO_PI

    # Peter Kutz not-normal trick (interactions.cu:22-34)
    ax = jnp.abs(normal.x) < SQRT_OF_ONE_THIRD
    ay = jnp.abs(normal.y) < SQRT_OF_ONE_THIRD
    one = jnp.ones_like(normal.x)
    zero = jnp.zeros_like(normal.x)
    nn_x = jnp.where(ax, one, zero)
    nn_y = jnp.where(ax, zero, jnp.where(ay, one, zero))
    nn_z = jnp.where(jnp.logical_or(ax, ay), zero, one)
    not_normal = Vec3(nn_x, nn_y, nn_z)

    p1 = normal.cross(not_normal).normalize()
    p2 = normal.cross(p1).normalize()
    return (normal * up
            + p1 * (jnp.cos(around) * over)
            + p2 * (jnp.sin(around) * over))


def fresnel_schlick(cos_theta, eta_i, eta_t):
    """Schlick approximation (interactions.cu:47-52). pow5 as multiplies."""
    r0 = (eta_i - eta_t) / (eta_i + eta_t)
    r0 = r0 * r0
    m = jnp.maximum(1.0 - cos_theta, 0.0)
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)


def reflect(incident: Vec3, normal: Vec3) -> Vec3:
    """glm::reflect."""
    return incident - normal * (2.0 * incident.dot(normal))


def refract(incident: Vec3, normal: Vec3, eta: jnp.ndarray) -> Vec3:
    """glm::refract: zero vector on total internal reflection.

    TIR lanes substitute k=1 BEFORE the sqrt: sqrt'(0) is inf, and
    inf * (zero tangent from the select) = NaN in reverse mode — the select
    alone does not protect gradients.
    """
    cos_i = -incident.dot(normal)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    # near-critical-angle lanes count as TIR: the true d(direction)/d(eta)
    # diverges as k -> 0+ (sqrt' blows up), which is physically real but
    # numerically fatal in reverse mode; the cutoff reflects a measure-zero
    # sliver of directions
    tir = k < 1e-6
    k_safe = jnp.where(tir, 1.0, k)
    coeff = eta * cos_i - jnp.sqrt(k_safe)
    out = incident * eta + normal * coeff
    zero = Vec3.zeros(cos_i.shape, cos_i.dtype)
    return Vec3.where(tir, zero, out)


class LaneMaterials(NamedTuple):
    """Per-lane material parameters (gathered by material id)."""

    color: Vec3
    specular_color: Vec3
    has_reflective: jnp.ndarray
    has_refractive: jnp.ndarray
    ior: jnp.ndarray
    emittance: jnp.ndarray


def gather_material(materials: MaterialArrays, mat_id: jnp.ndarray
                    ) -> LaneMaterials:
    """Per-lane material parameter fetch (the reference reads
    materials[intersection.materialId], pathtrace.cu:550).

    For small tables this unrolls to a select chain (pure elementwise
    selects, no gather); larger tables fall back to jnp gathers.
    """
    m = materials.count
    if m <= MATERIAL_SELECT_MAX:
        def sel(table):
            out = jnp.full_like(mat_id, 0.0, dtype=table.dtype) + table[0]
            for k in range(1, m):
                out = jnp.where(mat_id == k, table[k], out)
            return out

        return LaneMaterials(
            color=Vec3(sel(materials.color[:, 0]), sel(materials.color[:, 1]),
                       sel(materials.color[:, 2])),
            specular_color=Vec3(sel(materials.specular_color[:, 0]),
                                sel(materials.specular_color[:, 1]),
                                sel(materials.specular_color[:, 2])),
            has_reflective=sel(materials.has_reflective),
            has_refractive=sel(materials.has_refractive),
            ior=sel(materials.ior),
            emittance=sel(materials.emittance),
        )
    mid = jnp.maximum(mat_id, 0)
    return LaneMaterials(
        color=Vec3.from_array(materials.color[mid]),
        specular_color=Vec3.from_array(materials.specular_color[mid]),
        has_reflective=materials.has_reflective[mid],
        has_refractive=materials.has_refractive[mid],
        ior=materials.ior[mid],
        emittance=materials.emittance[mid],
    )


def _branch_prob_surrogate(took_first: jnp.ndarray, p: jnp.ndarray
                           ) -> jnp.ndarray:
    """Value-1 weight whose GRADIENT carries branch-probability derivatives.

    A probabilistic branch pick (u < p) is discrete: pathwise autodiff sees
    zero gradient w.r.t. parameters that only move p (e.g. IOR via the
    Schlick reflectance). Weighting the taken branch by p/stop_grad(p) (or
    (1-p)/(1-stop_grad(p))) leaves every sample's VALUE unchanged but makes
    the estimator's expectation differentiable:
      E[w·f] = p·f_first + (1-p)·f_other,  dE/dθ picks up dp·(f_first-f_other)
    — the likelihood-ratio term, fused into the pathwise estimator.
    """
    p0 = jax.lax.stop_gradient(p)
    w_first = p / jnp.maximum(p0, 1e-6)
    w_other = (1.0 - p) / jnp.maximum(1.0 - p0, 1e-6)
    return jnp.where(took_first, w_first, w_other)


class ScatterResult(NamedTuple):
    origin: Vec3
    direction: Vec3
    throughput: Vec3  # multiplier applied to path color


def scatter_ray(direction: Vec3, hit_point: Vec3, normal: Vec3,
                m: LaneMaterials,
                u_pick: jnp.ndarray, u1: jnp.ndarray, u2: jnp.ndarray,
                u_fresnel: jnp.ndarray,
                any_glossy: bool = True,
                any_refractive: bool = True) -> ScatterResult:
    """Vectorized scatterRay (interactions.cu:54-149) over [N] lanes.

    Branch structure of the reference:
      diffuse    iff refl == 0 and refr == 0
      glossy     iff refl != 0 and refr == 0   (luminance-weighted pick)
      refractive iff refr != 0                 (Schlick Russian roulette)

    `any_glossy` / `any_refractive` are TRACE-TIME flags (from the scene's
    material table, RenderSettings): a branch no material can take is not
    computed at all — the analogue of the reference's warp-coherent
    uber-kernel being cheap when a scene uses one BSDF. On all-diffuse scenes
    this removes the Fresnel/refract/reflect chains (2 extra normalizes,
    a sqrt, and ~60 elementwise ops per lane per bounce).
    """
    base_origin = hit_point + normal * SCATTER_EPS  # interactions.cu:62

    # --- Diffuse sample (also the glossy diffuse sub-branch), :65-69
    diff_dir = cosine_hemisphere(normal, u1, u2)
    out_dir = diff_dir
    out_origin = base_origin
    throughput = m.color

    if any_glossy:
        # --- Glossy: luminance-weighted probabilistic pick, :72-104
        def luma(c: Vec3):
            return c.x * LUMA_R + c.y * LUMA_G + c.z * LUMA_B

        is_gloss = jnp.logical_and(m.has_reflective != 0.0,
                                   m.has_refractive == 0.0)
        roughness = 1.0 - m.has_reflective
        diffuse_luma = luma(m.color) * (roughness + 0.2)
        specular_luma = luma(m.specular_color) * (1.0 - roughness)
        p_diffuse = diffuse_luma / (diffuse_luma + specular_luma + 1e-6)
        gloss_take_diffuse = u_pick < p_diffuse
        mirror_dir = reflect(direction, normal).normalize()
        gloss_dir = Vec3.where(gloss_take_diffuse, diff_dir, mirror_dir)
        gloss_thr = Vec3.where(gloss_take_diffuse, m.color, m.specular_color)
        gloss_thr = gloss_thr * _branch_prob_surrogate(gloss_take_diffuse,
                                                       p_diffuse)
        out_dir = Vec3.where(is_gloss, gloss_dir, out_dir)
        throughput = Vec3.where(is_gloss, gloss_thr, throughput)

    if any_refractive:
        # --- Refractive, :107-146
        is_refr = m.has_refractive != 0.0
        cos_i0 = -direction.dot(normal)
        entering = cos_i0 > 0.0
        flip = jnp.where(entering, 1.0, -1.0)
        r_normal = normal * flip
        cos_i = jnp.abs(cos_i0)
        # non-refractive lanes have ior=0; they are select-masked out below,
        # but eta=inf would leak NaNs through jnp.where GRADIENTS
        ior = jnp.where(m.ior > 0.0, m.ior, 1.0)
        ior_from = jnp.where(entering, 1.0, ior)
        ior_to = jnp.where(entering, ior, 1.0)
        eta = ior_from / ior_to
        reflect_prob = fresnel_schlick(cos_i, ior_from, ior_to)
        refr_dir = refract(direction, r_normal, eta)
        tir = refr_dir.length_sq() < 1e-16  # |v| < 1e-8, interactions.cu:132
        do_reflect = jnp.logical_or(tir, u_fresnel < reflect_prob)
        refl_dir = reflect(direction, r_normal).normalize()
        refr_dir_n = Vec3.where(tir, r_normal, refr_dir).normalize()
        refract_out_dir = Vec3.where(do_reflect, refl_dir, refr_dir_n)
        refract_origin = Vec3.where(do_reflect,
                                    hit_point + r_normal * SCATTER_EPS,
                                    hit_point - r_normal * SCATTER_EPS)
        refract_thr = Vec3.where(do_reflect, m.specular_color, m.color)
        # Fresnel-pick probability surrogate (skip TIR lanes: forced branch)
        refract_thr = refract_thr * jnp.where(
            tir, 1.0, _branch_prob_surrogate(do_reflect, reflect_prob))
        out_dir = Vec3.where(is_refr, refract_out_dir, out_dir)
        out_origin = Vec3.where(is_refr, refract_origin, out_origin)
        throughput = Vec3.where(is_refr, refract_thr, throughput)

    return ScatterResult(out_origin, out_dir, throughput)


def shade(origin: Vec3, direction: Vec3, color: Vec3,
          remaining_bounces: jnp.ndarray,
          t: jnp.ndarray, normal: Vec3, mat_id: jnp.ndarray,
          materials: MaterialArrays, uniforms: jnp.ndarray,
          any_glossy: bool = True, any_refractive: bool = True,
          depth_quirk: bool = False, rr_depth: jnp.ndarray | None = None,
          rr_start: int = 0):
    """Vectorized shadeRealMaterial (pathtrace.cu:524-571).

    Args:
      origin/direction/color: path SoA (Vec3 of [N]).
      remaining_bounces [N] i32 (>0 live, ==0 done, <0 gathered).
      t/normal/mat_id: intersection SoA from intersect_scene.
      uniforms: tuple of [N] draws (pick, u1, u2, fresnel[, rr]).
      any_glossy/any_refractive: trace-time material-table capability flags
        (see scatter_ray) — dead BSDF branches are never built.
      rr_depth/rr_start: Russian-roulette throughput termination — absent
        from the reference (its README lists it as future work, README.md:395)
        but required by the north star. When rr_start > 0, a path that
        scatters at depth >= rr_start survives with probability
        p = clamp(max(throughput), 0.05, 1) and its color is divided by p
        (unbiased). rr_depth is the per-lane (or scalar) CURRENT depth;
        uniforms[4] is consumed as the survival draw.
      depth_quirk: replicate the CURRENT reference code's termination quirk
        (SURVEY.md §3.2c): a path whose bounce budget runs out contributes its
        raw throughput (gatherImage, pathtrace.cu:574-589). Default False =
        textbook termination (depth-truncated paths contribute nothing),
        which is what the reference's own checked-in golden render shows
        (img/reference/REFERENCE_cornell.5000samp.png matches us at block MAD
        0.002 / corr 0.9995 without the quirk, but is 23% dimmer than either
        renderer WITH it — the PNG predates the quirk).

    Returns updated (origin, direction, color, remaining_bounces). Lanes with
    remaining_bounces <= 0 on entry pass through unchanged (the reference skips
    gathered lanes at pathtrace.cu:536-541; compacted lanes are all live).
    """
    active = remaining_bounces > 0
    m = gather_material(materials, mat_id)
    hit = t > 0.0
    emissive = jnp.logical_and(hit, m.emittance > 0.0)
    miss = jnp.logical_not(hit)
    do_scatter = jnp.logical_and(
        active, jnp.logical_and(hit, jnp.logical_not(emissive)))

    hit_point = origin + direction * t

    sc = scatter_ray(direction, hit_point, normal, m,
                     uniforms[0], uniforms[1], uniforms[2],
                     uniforms[3], any_glossy=any_glossy,
                     any_refractive=any_refractive)

    new_origin = Vec3.where(do_scatter, sc.origin, origin)
    new_direction = Vec3.where(do_scatter, sc.direction, direction)

    new_color = Vec3.where(do_scatter, color * sc.throughput, color)
    emissive_active = jnp.logical_and(active, emissive)
    new_color = Vec3.where(emissive_active,
                           color * m.color * m.emittance, new_color)
    miss_active = jnp.logical_and(active, miss)
    zero = Vec3.zeros(t.shape, t.dtype)
    new_color = Vec3.where(miss_active, zero, new_color)  # background black

    new_rb = jnp.where(do_scatter, remaining_bounces - 1, remaining_bounces)
    if rr_start > 0:
        # Russian roulette: unbiased stochastic termination by throughput
        p = jnp.clip(jnp.maximum(new_color.x,
                                 jnp.maximum(new_color.y, new_color.z)),
                     0.05, 1.0)
        rr_active = jnp.logical_and(do_scatter, rr_depth >= rr_start)
        killed = jnp.logical_and(rr_active, uniforms[4] >= p)
        boost = jnp.where(jnp.logical_and(rr_active,
                                          jnp.logical_not(killed)),
                          1.0 / p, 1.0)
        new_color = new_color * boost
        new_rb = jnp.where(killed, -2, new_rb)
    if not depth_quirk:
        # depth-exhausted paths die unlit (-2: dead, never gathered)
        new_rb = jnp.where(jnp.logical_and(do_scatter, new_rb == 0), -2, new_rb)
    new_rb = jnp.where(jnp.logical_or(emissive_active, miss_active), 0, new_rb)
    return new_origin, new_direction, new_color, new_rb
