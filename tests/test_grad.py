"""Differentiable-rendering gradient checks (finite differences vs autodiff).

The north-star requirement beyond the reference: jax.grad flows through the
whole bounce loop (reparameterized sampling — fixed uniforms, smooth
dependence on continuous parameters). Verified against central finite
differences for material albedo, emittance, and camera position.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.engine.wavefront import render_iteration, zero_accum


def _loss_fn(scene, settings, param_path):
    """Scalar image loss as a function of one continuous parameter leaf."""

    def set_param(s, value):
        if param_path == "albedo":
            return s._replace(materials=s.materials._replace(color=value))
        if param_path == "emittance":
            return s._replace(
                materials=s.materials._replace(emittance=value))
        if param_path == "cam_pos":
            return s._replace(camera=s.camera._replace(position=value))
        if param_path == "ior":
            return s._replace(materials=s.materials._replace(ior=value))
        raise ValueError(param_path)

    def get_param(s):
        if param_path == "albedo":
            return s.materials.color
        if param_path == "emittance":
            return s.materials.emittance
        if param_path == "cam_pos":
            return s.camera.position
        if param_path == "ior":
            return s.materials.ior
        raise ValueError(param_path)

    @jax.jit
    def loss(value):
        s = set_param(scene, value)
        img = render_iteration(s, settings, zero_accum(settings), jnp.int32(1),
                               seed=0, early_exit=False)
        return (img.x.sum() + img.y.sum() + img.z.sum()) / settings.pixel_count

    return loss, get_param(scene)


@pytest.mark.parametrize("param,eps,rtol", [
    ("albedo", 1e-3, 0.05),
    ("emittance", 1e-3, 0.05),
])
def test_grad_matches_finite_difference(cornell_small, param, eps, rtol):
    scene, settings = cornell_small
    settings = dataclasses.replace(settings, width=32, height=32,
                                   trace_depth=3)
    loss, p0 = _loss_fn(scene, settings, param)

    g = jax.grad(loss)(p0)
    g = np.asarray(g)
    assert np.isfinite(g).all()

    # check the largest-|grad| coordinates against central differences
    flat = g.ravel()
    order = np.argsort(-np.abs(flat))[:3]
    p0_np = np.asarray(p0, dtype=np.float64)
    checked = 0
    for i in order:
        if abs(flat[i]) < 1e-6:
            continue
        dp = np.zeros_like(p0_np).ravel()
        dp[i] = eps
        dp = dp.reshape(p0_np.shape)
        lp = float(loss(jnp.asarray(p0_np + dp, jnp.float32)))
        lm = float(loss(jnp.asarray(p0_np - dp, jnp.float32)))
        fd = (lp - lm) / (2 * eps)
        assert fd == pytest.approx(flat[i], rel=rtol, abs=1e-5), (
            f"{param}[{i}]: autodiff {flat[i]} vs FD {fd}")
        checked += 1
    assert checked >= 1


def test_camera_grad_zero_almost_everywhere(cornell_small):
    """With fixed uniforms and diffuse materials, path radiance is a product
    of albedos/emittance — independent of geometry except through DISCRETE
    visibility events. The reparameterized estimator's camera-position
    gradient is therefore zero almost everywhere, and autodiff must agree
    (boundary/edge sampling, which would recover the interior derivative of
    the expected image, is out of the reference's scope)."""
    scene, settings = cornell_small
    settings = dataclasses.replace(settings, width=16, height=16,
                                   trace_depth=2)
    loss, p0 = _loss_fn(scene, settings, "cam_pos")
    g = np.asarray(jax.grad(loss)(p0))
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, 0.0, atol=1e-5)


def test_grad_zero_for_unused_material(cornell_small):
    """A material no geometry references must get zero albedo gradient."""
    scene, settings = cornell_small
    settings = dataclasses.replace(settings, width=16, height=16,
                                   trace_depth=2)
    used = set(np.asarray(scene.geoms.material_id).tolist())
    unused = [m for m in range(scene.materials.count) if m not in used]
    if not unused:
        pytest.skip("all materials used in this scene")
    loss, p0 = _loss_fn(scene, settings, "albedo")
    g = np.asarray(jax.grad(loss)(p0))
    for m in unused:
        np.testing.assert_allclose(g[m], 0.0, atol=1e-8)


def test_branch_prob_surrogate_expectation_gradient():
    """The likelihood-ratio surrogate (ops/bsdf._branch_prob_surrogate) must
    make the EXPECTED estimator differentiable with the correct gradient:
    E[w(u,p)·f(u,p)] = p·f_r + (1-p)·f_t, dE/dp = f_r - f_t.
    Checked against the analytic value on a dense uniform grid (deterministic,
    no MC noise)."""
    from pathtracer_tpu.ops.bsdf import _branch_prob_surrogate

    f_r, f_t = 3.0, 0.5
    u = (jnp.arange(100000, dtype=jnp.float32) + 0.5) / 100000.0

    def expected(p):
        took = u < p
        w = _branch_prob_surrogate(took, jnp.full_like(u, p))
        f = jnp.where(took, f_r, f_t)
        return jnp.mean(w * f)

    for p0 in (0.2, 0.5, 0.9):
        val = float(expected(jnp.float32(p0)))
        assert val == pytest.approx(p0 * f_r + (1 - p0) * f_t, rel=1e-3)
        g = float(jax.grad(expected)(jnp.float32(p0)))
        assert g == pytest.approx(f_r - f_t, rel=1e-3)


def test_ior_gradient_matches_finite_difference_expectation():
    """Expectation-level FD check of the IOR gradient through the REAL
    scatter path: half a million refractive scatters (real RNG streams, real
    scatter_ray incl. the fused likelihood-ratio surrogate), expectation =
    mean of throughput-weighted smooth function of the outgoing direction.
    Central FD at eps=0.01 realizes ~10^3 deterministic Fresnel branch flips
    — enough that FD resolves both the continuous (refract direction moves
    with eta) and discrete (reflect/refract pick probability) parts of
    dE/d_ior, which autodiff must match within 5%.

    Why not a full-render FD: a pathwise render's brightness is piecewise
    constant in IOR (albedo products don't depend on geometry), so FD there
    only sees branch flips — and a CPU-sized render realizes a handful of
    flips, giving FD estimates with >100% spread (measured; the sum even
    flips sign between eps choices). The expectation-level contract is
    exactly what this test checks, at a sample count where FD converges.
    """
    from pathtracer_tpu.ops import rng as prng
    from pathtracer_tpu.ops.bsdf import LaneMaterials, scatter_ray
    from pathtracer_tpu.utils.vec import Vec3

    n = 1 << 19
    lanes = jnp.arange(n, dtype=jnp.int32)
    st = prng.decision_state(7, 1, 0, lanes)
    u_pick, u1, u2, u_fres, ua, ub = prng.fast_uniforms_perlane(st, 6)
    # incident directions over the lower hemisphere (varied cos_i exercises
    # the angle dependence of the Schlick derivative)
    phi = 2.0 * jnp.pi * ua
    cos_t = 0.05 + 0.9 * ub
    sin_t = jnp.sqrt(1.0 - cos_t * cos_t)
    d = Vec3(sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), -cos_t)
    normal = Vec3(jnp.zeros(n), jnp.zeros(n), jnp.ones(n))
    hit = Vec3.zeros((n,))

    def mats(ior):
        one = jnp.ones(n)
        return LaneMaterials(
            color=Vec3(0.2 * one, 0.5 * one, 0.9 * one),
            specular_color=Vec3(one, 0.8 * one, 0.6 * one),
            has_reflective=jnp.zeros(n),
            has_refractive=one,
            ior=ior * one,
            emittance=jnp.zeros(n),
        )

    @jax.jit
    def loss(ior):
        r = scatter_ray(d, hit, normal, mats(ior), u_pick, u1, u2, u_fres)
        smooth = (3.0 + r.direction.x + 2.0 * r.direction.y
                  + r.direction.z) / 6.0
        f = (r.throughput.x + r.throughput.y + r.throughput.z) * smooth
        return jnp.mean(f)

    at = jnp.float32(1.55)
    g = float(jax.grad(loss)(at))
    eps = 0.01
    fd = (float(loss(at + eps)) - float(loss(at - eps))) / (2 * eps)
    assert np.isfinite(g) and abs(fd) > 1e-4
    assert g == pytest.approx(fd, rel=0.05), f"AD {g} vs FD {fd}"


@pytest.mark.slow
def test_ior_gradient_finite_and_nonzero():
    """IOR gradients through the renderer: the pure pathwise estimator sees
    zero (eta only moves discrete events), so scatter_ray fuses the surrogate
    into the Fresnel pick. Render-level check: gradients are finite and
    nonzero (their sign/magnitude is an expectation-level property with high
    single-image variance; the surrogate's correctness is verified
    deterministically above)."""
    import os

    from pathtracer_tpu.scene.fixtures import scene_path
    path = scene_path("test_scene")
    if not os.path.exists(path):
        pytest.skip("reference scenes unavailable")
    from pathtracer_tpu import load_scene
    from pathtracer_tpu.engine.wavefront import render_iteration

    scene, settings = load_scene(path, overrides={"RES": [32, 32],
                                                  "DEPTH": 4})

    @jax.jit
    def render_with_ior(ior):
        s = scene._replace(materials=scene.materials._replace(ior=ior))
        return render_iteration(s, settings, zero_accum(settings),
                                jnp.int32(1), seed=0, early_exit=False)

    target = render_with_ior(scene.materials.ior)

    @jax.jit
    def loss(ior):
        img = render_with_ior(ior)
        d = ((img.x - target.x) ** 2 + (img.y - target.y) ** 2
             + (img.z - target.z) ** 2)
        return d.sum() / settings.pixel_count

    start = jnp.where(scene.materials.ior > 0, scene.materials.ior + 0.3,
                      scene.materials.ior)
    g = np.asarray(jax.grad(loss)(start))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 1e-6, "IOR gradient identically zero"
    # non-refractive materials must get exactly zero IOR gradient
    refr = np.asarray(scene.materials.has_refractive) > 0
    np.testing.assert_allclose(g[~refr], 0.0, atol=1e-8)


@pytest.mark.parametrize("impl", ["jnp", "triton"])
def test_mesh_albedo_grad_matches_finite_difference(impl):
    """Mesh-scene differentiability (BASELINE config 5): the albedo gradient
    flows through the bounce loop on a BVH scene, for both the fully
    differentiable jnp walk and the GPU kernel (interpret mode here).

    The kernel returns its hit geometry under stop_gradient
    (ops/intersect.py): exact for material parameters, since (t, normal,
    material id) do not depend on albedo — FD agreement proves it."""
    from pathtracer_tpu import load_scene
    from pathtracer_tpu.scene.fixtures import scene_path

    scene, settings = load_scene(scene_path("teapot"), overrides={
        "RES": [24, 24], "DEPTH": 3, "ITERATIONS": 1})
    settings = dataclasses.replace(settings, bvh_impl=impl,
                                   interpret=impl == "triton")
    loss, p0 = _loss_fn(scene, settings, "albedo")

    g = np.asarray(jax.grad(loss)(p0))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 1e-6, "albedo gradient identically zero"

    eps = 1e-3
    flat = g.ravel()
    order = np.argsort(-np.abs(flat))[:2]
    p0_np = np.asarray(p0, dtype=np.float64)
    for i in order:
        dp = np.zeros_like(p0_np).ravel()
        dp[i] = eps
        dp = dp.reshape(p0_np.shape)
        lp = float(loss(jnp.asarray(p0_np + dp, jnp.float32)))
        lm = float(loss(jnp.asarray(p0_np - dp, jnp.float32)))
        fd = (lp - lm) / (2 * eps)
        assert fd == pytest.approx(flat[i], rel=0.05, abs=1e-5), (
            f"albedo[{i}] ({impl}): autodiff {flat[i]} vs FD {fd}")


def test_mesh_albedo_grad_kernel_matches_jnp():
    """The kernel's albedo gradient equals the jnp walk's: the two
    intersectors return identical hit geometry (tests/test_bvh_walk.py), and
    material gradients depend on geometry only through the primal values."""
    from pathtracer_tpu import load_scene
    from pathtracer_tpu.scene.fixtures import scene_path

    scene, settings = load_scene(scene_path("teapot"), overrides={
        "RES": [24, 24], "DEPTH": 3, "ITERATIONS": 1})
    grads = {}
    for impl in ("jnp", "triton"):
        s = dataclasses.replace(settings, bvh_impl=impl,
                                interpret=impl == "triton")
        loss, p0 = _loss_fn(scene, s, "albedo")
        grads[impl] = np.asarray(jax.grad(loss)(p0))
    np.testing.assert_allclose(grads["triton"], grads["jnp"],
                               rtol=1e-5, atol=1e-7)
