"""Full-scale golden-parity regression on the GPU: re-verifies the
committed PARITY.md artifact.

Runs the SAME comparison as tools/golden_parity.py at 1000 spp and asserts
the PARITY.md envelope scaled for the lower sample count: the committed
2000-spp artifact measured 8x8-block MAD 0.0018 / 16x16 0.0011 / corr 0.986
/ channel-mean deltas <= 0.0003. Per-pixel correlation is bounded by the
Monte-Carlo noise of both renders: on an H100 the same renderer measured
corr 0.9559 at 300 spp (block MADs 0.0035 / 0.0019), so the 0.97 bound
needs more than ~500 spp; 1000 spp keeps every bound below with headroom
only while the renderer still matches the reference image.

The 800x800x1000spp render needs the card (the CPU backend would take
hours), so the test is marked `gpu` and `slow`:
    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""
import pytest


@pytest.mark.slow
@pytest.mark.gpu
def test_full_scale_parity_envelope(gpu):
    from tools.golden_parity import compute_parity

    m = compute_parity(spp=1000, chunk=100, png_path=None)
    assert m["b8_mean"] < 0.006, m
    assert m["b16_mean"] < 0.004, m
    assert m["corr"] > 0.97, m
    assert m["mean_delta"].max() < 0.004, m
