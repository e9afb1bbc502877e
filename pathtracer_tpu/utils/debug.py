"""Numerical-safety validation — the ERRORCHECK-flag equivalent.

The reference's only sanitizer is an opt-in sync-and-check after each kernel
launch (checkCUDAError, pathtrace.cu:26,44-67). Here the check is on
numerics, not launches: one full render iteration is checkified for NaN/Inf
in every intermediate (checkify.float_checks), so a regression in any
kernel's math is caught with a named error instead of a corrupted image.

Usage: utils/debug.validate_iteration(scene, settings) in tests/CI, or
`python -c "from pathtracer_tpu.utils.debug import validate_iteration; ..."`
after suspicious changes. (For interactive debugging, JAX's global
jax.config.update("jax_debug_nans", True) also works with the engines — the
scan-mode bounce loop contains no NaN-producing selects by construction; see
Vec3.normalize's clamp.)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from ..engine.wavefront import render_iteration, zero_accum
from ..scene.types import RenderSettings, SceneArrays


def validate_iteration(scene: SceneArrays, settings: RenderSettings,
                       seed: int = 0) -> None:
    """Run one checkified render iteration; raises on any NaN/Inf.

    Note: uses the scan-mode (differentiable) loop — checkify does not
    support the early-exit while_loop's data-dependent trip count.
    """
    def f(scene, accum):
        return render_iteration(scene, settings, accum, jnp.int32(1),
                                seed=seed, early_exit=False)

    checked = checkify.checkify(f, errors=checkify.float_checks)
    err, out = jax.jit(checked)(scene, zero_accum(settings))
    err.throw()
    jax.block_until_ready(out)
