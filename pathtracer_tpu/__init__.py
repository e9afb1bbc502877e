"""Wavefront path tracer in JAX for the GPU.

A from-scratch re-design of the capabilities of vismaychuriwala/CUDA-Path-Tracer:
fixed-size masked wavefront inside jit, a Pallas (Triton) kernel for the BVH
walk, shard_map data parallelism over the ray pool, and a differentiable
render loop (gradients w.r.t. materials and camera through reparameterized
sampling).
"""

from .scene.loader import load_scene
from .scene.types import RenderSettings, SceneArrays
from .engine.wavefront import render, render_iteration

__version__ = "0.1.0"
__all__ = ["load_scene", "RenderSettings", "SceneArrays", "render",
           "render_iteration"]
