"""Golden-image parity vs the reference's checked-in CUDA render.

The reference repository ships img/reference/REFERENCE_cornell.5000samp.png
(800x800, 5000 spp; copied to scenes/golden/). The FULL-SCALE comparison is
a committed artifact: PARITY.md, produced by tools/golden_parity.py
at 800x800/2000 spp — 8x8-block MAD 0.0018 (max 0.17 on the noisy
light-edge blocks), 16x16-block MAD 0.0011, correlation 0.986, per-channel
mean deltas 0.0003. With depth_quirk=True we reproduce the CURRENT
reference code's behavior instead, which is ~23% brighter than its own
golden image (the PNG predates the quirk — see ops/bsdf.py shade).

These tests render small (CPU-friendly) across MULTIPLE seeds and compare
block means with tolerances derived from the measured per-seed envelope
(96 spp at 64x64: brightness delta 0.0033-0.0043, block MAD 0.0092-0.0108,
corr 0.986-0.990 over seeds 0-2) — tight enough that a few-percent dimming
or material regression fails every seed. The full-scale artifact itself is
re-verified on the GPU by test_parity_full.py and chip_smoke.py.
"""
import os

import numpy as np
import pytest

from pathtracer_tpu import load_scene
from pathtracer_tpu.engine.wavefront import render
from pathtracer_tpu.io.image import load_png

from pathtracer_tpu.scene.fixtures import golden_path, scene_path

GOLDEN = golden_path()
needs_golden = pytest.mark.skipif(not os.path.exists(GOLDEN),
                                  reason="golden unavailable")


@pytest.fixture(scope="module")
def golden_blocks():
    ref = load_png(GOLDEN)
    assert ref.shape == (800, 800, 3)
    return ref.reshape(8, 100, 8, 100, 3).mean(axis=(1, 3))


@pytest.fixture(scope="module")
def cornell_64():
    return load_scene(scene_path("cornell"),
                      overrides={"RES": [64, 64], "DEPTH": 8})


def _render_blocks(cornell_64, seed):
    scene, settings = cornell_64
    img = np.asarray(render(scene, settings, iterations=96, chunk=32,
                            seed=seed))
    img = np.clip(img, 0.0, 1.0)[:, ::-1, :]  # saveImage mirror (main.cpp:407)
    return img, img.reshape(8, 8, 8, 8, 3).mean(axis=(1, 3))


@needs_golden
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cornell_matches_reference_render(golden_blocks, cornell_64, seed):
    rb = golden_blocks
    img, ob = _render_blocks(cornell_64, seed)

    # measured per-seed envelope (module docstring) + ~40% headroom
    assert abs(rb.mean() - ob.mean()) < 0.006         # global brightness
    assert np.abs(rb - ob).mean() < 0.013             # block error
    corr = np.corrcoef(rb.ravel(), ob.ravel())[0, 1]
    assert corr > 0.98                                # structure

    # orientation: red wall left, green wall right (in the mirrored frame)
    left = img[24:40, 4:12]
    right = img[24:40, 52:60]
    assert left[..., 0].mean() > left[..., 1].mean()    # red dominant
    assert right[..., 1].mean() > right[..., 0].mean()  # green dominant


@needs_golden
@pytest.mark.slow
def test_cornell_seed_average_tight(golden_blocks, cornell_64):
    """Averaging 3 independent seeds (288 spp total) squeezes the Monte-
    Carlo noise: the residual envelope (measured brightness 0.0037, block
    MAD 0.0083, corr 0.9905) is the systematic floor, so the bounds here
    catch sub-percent brightness regressions the per-seed test can't."""
    rb = golden_blocks
    obs = [_render_blocks(cornell_64, seed)[1] for seed in (0, 1, 2)]
    ob = np.mean(obs, axis=0)
    assert abs(rb.mean() - ob.mean()) < 0.005
    assert np.abs(rb - ob).mean() < 0.010
    assert np.corrcoef(rb.ravel(), ob.ravel())[0, 1] > 0.985
