"""Multi-device tests on the 8-way virtual CPU mesh (conftest sets
xla_force_host_platform_device_count=8)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.engine.wavefront import render_chunk, zero_accum
from pathtracer_tpu.parallel.sharding import (albedo_fit_step, make_ray_mesh,
                                              render_chunk_sharded,
                                              render_sharded, replicate,
                                              shard_accum)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    return make_ray_mesh()


@pytest.mark.slow
def test_sharded_render_statistically_matches(cornell_small, mesh):
    """The sharded render uses different RNG streams but must agree in
    expectation with the single-device render."""
    scene, settings = cornell_small
    n_iters = 32
    from pathtracer_tpu.engine.wavefront import lanes_to_image

    single = render_chunk(scene, settings, zero_accum(settings), jnp.int32(1),
                          n_iters, 0, True)
    img1 = lanes_to_image(single * (1.0 / n_iters), settings).reshape(-1, 3)

    img2 = np.asarray(render_sharded(scene, settings, mesh,
                                     iterations=n_iters, chunk=n_iters))
    img2 = img2.reshape(-1, 3)
    # pixel-mean brightness within MC tolerance
    assert abs(img1.mean() - img2.mean()) < 0.03
    # structural agreement: correlation of the two noisy renders is high
    c = np.corrcoef(img1.ravel(), img2.ravel())[0, 1]
    assert c > 0.9


def test_sharded_shapes_and_placement(cornell_small, mesh):
    scene, settings = cornell_small
    scene_r = replicate(scene, mesh)
    accum = shard_accum(zero_accum(settings), mesh)
    out = render_chunk_sharded(scene_r, settings, mesh, accum, jnp.int32(1), 2,
                               0, False)
    assert out.x.shape == (settings.pixel_count,)
    # output stays sharded over the mesh (no implicit gather)
    assert len(out.x.sharding.device_set) == mesh.size


@pytest.mark.slow
def test_albedo_fit_step_runs_and_descends(cornell_small, mesh):
    """One sharded differentiable step must produce a finite loss and a
    gradient that changes the albedo toward the target."""
    scene, settings = cornell_small
    scene_r = replicate(scene, mesh)
    accum = shard_accum(zero_accum(settings), mesh)
    target = render_chunk_sharded(scene_r, settings, mesh, accum, jnp.int32(1),
                                  1, 0, False)

    # perturb the albedo away from truth, then take one step against target
    mats = scene_r.materials
    wrong = jnp.clip(mats.color + 0.2, 0.0, 1.0)
    scene_wrong = scene_r._replace(materials=mats._replace(color=wrong))

    s1, loss1 = albedo_fit_step(scene_wrong, settings, mesh, target,
                                jnp.int32(1), lr=0.5, seed=0)
    assert np.isfinite(float(loss1))
    # second step at the updated point, same RNG: loss must not increase
    s2, loss2 = albedo_fit_step(s1, settings, mesh, target, jnp.int32(1),
                                lr=0.5, seed=0)
    assert float(loss2) <= float(loss1) + 1e-6


def test_persistent_sharded_bitexact_vs_single(cornell_small, mesh):
    """The sharded persistent engine must produce the SAME image as the
    single-device masked engine (pixel-keyed RNG), up to float accumulation
    order."""
    from pathtracer_tpu.parallel.sharding import render_persistent_sharded

    from pathtracer_tpu.engine.wavefront import lanes_to_image

    scene, settings = cornell_small
    spp = 8
    img_s = np.asarray(render_persistent_sharded(scene, settings, mesh,
                                                 iterations=spp))
    single = render_chunk(scene, settings, zero_accum(settings), jnp.int32(1),
                          spp, 0, True)
    img_1 = lanes_to_image(single * (1.0 / spp), settings)
    np.testing.assert_allclose(img_s, img_1, rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_scaling_harness_runs(cornell_small, mesh):
    from pathtracer_tpu.parallel.sharding import scaling_efficiency

    scene, settings = cornell_small
    r = scaling_efficiency(scene, settings, [1, 2], iterations=4)
    assert set(r) == {1, 2}
    assert r[1]["rays_per_s"] > 0 and r[2]["rays_per_s"] > 0
    assert 0 < r[2]["efficiency"]  # CPU virtual devices: no perf claim


@pytest.mark.slow
def test_albedo_fit_converges(cornell_small, mesh):
    """North star: 'differentiable albedo recovery converging' — a multi-step
    SGD fit must substantially reduce both the loss and the albedo error."""
    scene, settings = cornell_small
    scene_r = replicate(scene, mesh)
    accum = shard_accum(zero_accum(settings), mesh)
    target = render_chunk_sharded(scene_r, settings, mesh, accum,
                                  jnp.int32(1), 1, 0, False)
    true_albedo = np.asarray(scene.materials.color)

    rng = np.random.default_rng(1)
    wrong = np.clip(true_albedo + rng.uniform(-0.2, 0.2, true_albedo.shape),
                    0.05, 0.95)
    s = scene_r._replace(materials=scene_r.materials._replace(
        color=jnp.asarray(wrong, np.float32)))
    err0 = np.abs(wrong - true_albedo).mean()

    # fixed iteration = shared randomness with the target: the loss is then
    # noise-free self-calibration (same-sample estimator) and SGD descends
    losses = []
    for k in range(12):
        s, loss = albedo_fit_step(s, settings, mesh, target,
                                  jnp.int32(1), lr=1.0, seed=0)
        losses.append(float(loss))
    err = np.abs(np.asarray(s.materials.color) - true_albedo).mean()
    assert losses[-1] < losses[0] * 0.5, f"loss did not halve: {losses}"
    assert err < err0 * 0.7, f"albedo error {err0:.4f} -> {err:.4f}"


@pytest.mark.slow
def test_albedo_fit_converges_mesh_scene(mesh):
    """BASELINE config 5 regression guard: the differentiable albedo fit on
    a MESH scene — gradients through the full bounce loop with the GPU
    kernel (interpret mode here) in the forward pass (hit geometry under
    stop_gradient, exact for material parameters) — must converge, not
    just run. Committed full-scale curve: FIT_alien.md."""
    import dataclasses

    from pathtracer_tpu import load_scene
    from pathtracer_tpu.scene.fixtures import scene_path

    scene, settings = load_scene(scene_path("teapot"),
                                 overrides={"RES": [32, 32], "DEPTH": 2})
    settings = dataclasses.replace(settings, bvh_impl="triton",
                                   interpret=True)
    scene_r = replicate(scene, mesh)
    accum = shard_accum(zero_accum(settings), mesh)
    target = render_chunk_sharded(scene_r, settings, mesh, accum,
                                  jnp.int32(1), 1, 0, False)
    true_albedo = np.asarray(scene.materials.color)

    rng = np.random.default_rng(3)
    wrong = np.clip(true_albedo + rng.uniform(-0.2, 0.2, true_albedo.shape),
                    0.05, 0.95)
    s = scene_r._replace(materials=scene_r.materials._replace(
        color=jnp.asarray(wrong, np.float32)))
    err0 = np.abs(wrong - true_albedo).mean()

    losses = []
    for _ in range(8):
        s, loss = albedo_fit_step(s, settings, mesh, target,
                                  jnp.int32(1), lr=1.0, seed=0)
        losses.append(float(loss))
    err = np.abs(np.asarray(s.materials.color) - true_albedo).mean()
    assert losses[-1] < losses[0] * 0.5, f"loss did not halve: {losses}"
    assert err < err0 * 0.75, f"albedo error {err0:.4f} -> {err:.4f}"


def test_interleaved_pixel_map_is_bijection(cornell_small):
    """The composed shard-interleave pixel map must be a bijection over the
    pool (lanes_to_image inverts it by scatter; RNG keys stay unique)."""
    import dataclasses

    scene, settings = cornell_small
    s = dataclasses.replace(settings, shard_interleave=8)
    pm = np.asarray(s.pixel_map()(np.arange(s.pixel_count, dtype=np.int64)))
    assert pm.shape == (s.pixel_count,)
    assert np.array_equal(np.sort(pm), np.arange(s.pixel_count))
    # composed with a tile-major base map (mesh scenes) it must stay one
    from pathtracer_tpu import load_scene
    from pathtracer_tpu.scene.fixtures import scene_path

    _, ts = load_scene(scene_path("teapot"), overrides={"RES": [64, 64]})
    assert ts.tile is not None
    t = dataclasses.replace(ts, shard_interleave=8)
    pmt = np.asarray(t.pixel_map()(np.arange(t.pixel_count, dtype=np.int64)))
    assert np.array_equal(np.sort(pmt), np.arange(t.pixel_count))


@pytest.mark.slow
def test_shard_work_balance_interleaved(mesh):
    """Per-shard work within a few % of ideal (the machine-checkable proxy
    for the environmentally-unmeasurable 85% 2-host rays/s target — see
    shard_work_counts docstring). Measured on the 8-virtual-device mesh:
    contiguous bands were 1.18x (cornell) / 1.65x (open scene) max/mean;
    the granule round-robin interleave brings both under 1.05x."""
    from pathtracer_tpu import load_scene
    from pathtracer_tpu.parallel.sharding import shard_work_counts
    from pathtracer_tpu.scene.fixtures import scene_path

    # teapot: mesh scenes have the most skewed per-pixel bounce work — the
    # mesh covers a small screen region — which is what the interleave is for
    for name, bound in (("cornell", 1.05), ("open_test_scene", 1.06),
                        ("teapot", 1.06)):
        scene, settings = load_scene(
            scene_path(name), overrides={"RES": [128, 128], "DEPTH": 8})
        w = shard_work_counts(scene, settings, mesh, iterations=4)
        ratio = w.max() / w.mean()
        assert ratio < bound, f"{name}: max/mean {ratio:.4f} >= {bound}"
        # and the interleave must actually beat contiguous bands
        w0 = shard_work_counts(scene, settings, mesh, iterations=4,
                               interleave=False)
        assert ratio < w0.max() / w0.mean()


@pytest.mark.slow
def test_kernel_intersect_sharded_bitexact(mesh):
    """The GPU mesh kernel (interpret mode here) under shard_map must return
    bit-identical hits to the single-device call (scene/BVH replicated, each
    shard pads and walks its own pool; per-lane closest hits do not depend
    on pool composition). Every other sharded test renders analytic scenes
    only."""
    from jax.sharding import PartitionSpec as P

    from pathtracer_tpu import load_scene
    from pathtracer_tpu.engine.wavefront import generate_paths
    from pathtracer_tpu.ops import rng as rng_mod
    from pathtracer_tpu.ops.intersect import intersect_scene
    from pathtracer_tpu.parallel.sharding import RAY_AXIS
    from pathtracer_tpu.scene.fixtures import scene_path

    scene, settings = load_scene(scene_path("teapot"),
                                 overrides={"RES": [64, 64], "DEPTH": 2})
    irng = rng_mod.IterationRng(True, 0, jnp.int32(1),
                                pixel_map=settings.pixel_map())
    state = generate_paths(scene, settings, irng)
    o, d = state.origin, state.direction

    def run(scene, o, d):
        return intersect_scene(scene, settings.geom_types, o, d,
                               bvh_impl="triton", interpret=True)

    t1, n1, m1 = jax.jit(run)(scene, o, d)

    sharded = jax.jit(jax.shard_map(
        run, mesh=mesh, in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=P(RAY_AXIS), check_vma=False))
    t2, n2, m2 = sharded(scene, o, d)

    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
    for c1, c2 in zip(n1, n2):
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
