"""Smoke tests for the tools (perfstats timing harness)."""
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.utils.profiling import measure_stages, ray_survival_report


@pytest.mark.slow
def test_perfstats_smoke(cornell_small):
    scene, settings = cornell_small
    report = ray_survival_report(scene, settings, iteration=2)
    assert "Initial rays: 4096" in report
    stats = measure_stages(scene, settings)
    table = stats.table()
    assert "Intersection" in table and "FUSED frame" in table
    assert stats.frame_ms > 0 and np.isfinite(stats.frame_ms)


def _xplane_stats():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools",
                        "xplane_stats.py")
    spec = importlib.util.spec_from_file_location("xplane_stats", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fake_profile():
    """A two-plane profile shaped like ProfileData's: one GPU device plane
    with an "XLA Ops" line, one host plane that must be ignored."""
    from types import SimpleNamespace as NS

    def ev(name, start, dur, **stats):
        return NS(name=name, start_ns=start, duration_ns=dur,
                  stats=list(stats.items()))

    gpu = NS(name="/device:GPU:0", lines=[
        NS(name="XLA Ops", events=[
            ev("fusion.1", 0, 1_000_000),                 # scope via HLO map
            ev("bvh_walk", 1_000_000, 3_000_000),         # kernel name
            ev("while.3", 0, 9_000_000),                  # container: skip
            ev("fusion.9", 6_000_000, 2_000_000),         # unattributed
        ]),
        NS(name="Stream #13(Compute)", events=[ev("x", 0, 99)]),
    ])
    host = NS(name="/host:CPU", lines=[
        NS(name="XLA Ops", events=[ev("fusion.1", 0, 5_000_000)])])
    return NS(planes=[host, gpu])


def test_hlo_scope_map_parses_op_names():
    xs = _xplane_stats()
    hlo = ('  %fusion.1 = f32[4]{0} fusion(%p), kind=kLoop, metadata='
           '{op_name="jit(render_chunk)/pt_raygen/add"}\n'
           '  ROOT %custom-call.7 = f32[4]{0} custom-call(%a), metadata='
           '{op_name="jit(render_chunk)/pt_intersect/pallas_call"}\n')
    m = xs.hlo_scope_map(hlo)
    assert m["fusion.1"].endswith("pt_raygen/add")
    assert "pt_intersect" in m["custom-call.7"]


def test_stage_attribution_gpu_planes():
    xs = _xplane_stats()
    scope = {"fusion.1": "jit(f)/pt_raygen/x",
             "custom-call.7": "jit(f)/pt_intersect/pallas_call"}
    per, other, total, n, busy = xs.stage_attribution(_fake_profile(), scope)
    assert n == 3                                  # container skipped
    assert per["pt_raygen"] == pytest.approx(1.0)  # ms
    assert per["pt_intersect"] == pytest.approx(3.0)
    assert other == pytest.approx(2.0) and total == pytest.approx(6.0)
    # ops cover [0, 4) and [6, 8) ms of an 8 ms window
    assert busy == pytest.approx(0.75)
