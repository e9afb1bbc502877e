"""Platform choices: the mesh traversal per JAX platform, the compile-cache
directory, and the device record every measurement prints."""
import os

import jax
import pytest

from pathtracer_tpu.ops.intersect import BVH_IMPLS, intersect_scene
from pathtracer_tpu.scene.loader import default_bvh_impl
from pathtracer_tpu.utils import compile_cache
from pathtracer_tpu.utils.device import device_record, require_gpu


@pytest.mark.parametrize("platform,impl", [("gpu", "triton"),
                                           ("cpu", "jnp")])
def test_bvh_impl_by_platform(platform, impl):
    assert default_bvh_impl(platform) == impl
    assert impl in BVH_IMPLS


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no mesh traversal"):
        default_bvh_impl(platform)


def test_loader_follows_the_backend(cornell_small):
    _, settings = cornell_small
    assert jax.default_backend() == "cpu"
    assert settings.bvh_impl == "jnp" and not settings.interpret


def test_intersect_scene_rejects_unknown_impl(cornell_small):
    from pathtracer_tpu.utils.vec import Vec3
    import jax.numpy as jnp

    scene, settings = cornell_small
    v = Vec3(jnp.zeros(4), jnp.zeros(4), jnp.ones(4))
    with pytest.raises(ValueError, match="unknown bvh_impl"):
        intersect_scene(scene, settings.geom_types, v, v, bvh_impl="binned")


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_repo(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    want = os.path.join(compile_cache.REPO_ROOT, ".jax_cache")
    assert compile_cache.cache_dir() == want
    assert os.path.exists(os.path.join(compile_cache.REPO_ROOT,
                                       "chip_smoke.py"))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


def test_device_record_names_the_device():
    rec = device_record(jax.devices())
    assert rec == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}
