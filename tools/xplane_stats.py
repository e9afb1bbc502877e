#!/usr/bin/env python
"""In-situ per-stage timing of the FUSED frame via an xplane device trace.

The reference's EVALUATION path wraps each CUDA kernel in cudaEvent timers
inside the real frame (reference src/pathtrace.cu:629-673). Under XLA the
frame is ONE fused program, so utils/profiling.py can only time stages as
isolated jits — an estimate that ignores how fusion reshuffles cost. This
tool measures the real thing:

  1. the engine's stages are wrapped in jax.named_scope markers
     (pt_raygen / pt_intersect / pt_shade / pt_gather, engine/wavefront.py),
     which XLA records per instruction as metadata op_name;
  2. a fused render_chunk runs under jax.profiler.trace -> one .xplane.pb,
     read with jax.profiler.ProfileData (no other package needed); the
     GPU's device planes ("/device:GPU:N") carry one event per kernel;
  3. the compiled module's HLO text supplies the instruction -> scope map
     (hlo_scope_map; a fusion carries its root op's scope, which is what
     XLA names the fusion after), control-flow CONTAINER events
     (while/cond/call wrap the leaf ops and would triple-charge the body)
     are excluded, and leaf device-op durations are attributed to their
     pt_* marker. The in-fused-frame stage table prints next to the
     isolated-jit estimate for reconciliation, with the device's busy share
     of the traced window (union of kernel intervals over the window).

Usage: python tools/xplane_stats.py [scene.json] [--res N] [--depth N]
       (needs a GPU for the device table; CPU traces have no device plane,
       and the isolated-jit table prints instead)
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ("pt_raygen", "pt_intersect", "pt_shade", "pt_gather")
# hand-written kernels, by the name their launches carry in the trace (the
# trace names a Triton launch after the kernel, not after its HLO op)
KERNEL_STAGES = {"bvh_walk": "pt_intersect"}


def _load_profile(pb_path: str):
    from jax.profiler import ProfileData

    return ProfileData.from_file(pb_path)


def hlo_scope_map(hlo_text: str) -> dict:
    """instruction name -> jax named_scope path, from compiled HLO text.

    Device events name the HLO instruction (or the kernel XLA emitted for
    it); the compiled module's text records each instruction's
    metadata={op_name="jit(...)/pt_intersect/..."}; joining the two
    recovers in-situ attribution.
    Fusion instructions carry their ROOT op's metadata, which is exactly
    the scope XLA names the fusion after.
    """
    import re
    out = {}
    pat = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?"
                     r"op_name=\"([^\"]*)\"")
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def _op_lines(plane):
    """The lines of a device plane that hold one event per executed op:
    "XLA Ops" when the trace has it, else the GPU stream lines."""
    lines = list(plane.lines)
    ops = [ln for ln in lines if "xla op" in ln.name.lower()
           and "async" not in ln.name.lower()]
    return ops or [ln for ln in lines if ln.name.lower().startswith("stream")]


def stage_attribution(profile, scope_map: dict = None):
    """Sum device-op durations per pt_* marker across the GPU planes.

    Returns (per_stage_ms: dict, other_ms, total_ms, n_events, busy_share).
    Events whose name/metadata carry several markers (fully fused across
    stages) are charged to the FIRST marker that appears, which matches how
    XLA names fusions after their root op's scope. `scope_map` (from
    hlo_scope_map) supplies the scope when the trace's own metadata lacks
    it. busy_share is the union of op intervals over the traced window
    (first op start to last op end), per device, averaged.
    """
    per = {s: 0.0 for s in STAGES}
    other = 0.0
    n_events = 0
    scope_map = scope_map or {}
    busy = []

    for plane in profile.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        spans = []
        for line in _op_lines(plane):
            for ev in line.events:
                name = ev.name
                # control-flow CONTAINER events (while/cond/call) nest the
                # leaf ops — counting them would charge the body twice
                if name.split(".")[0] in ("while", "conditional", "call",
                                          "closed_call"):
                    continue
                blob = " ".join([name, scope_map.get(name, "")]
                                + [st for k, st in KERNEL_STAGES.items()
                                   if k in name])
                for key, value in ev.stats:
                    if key in ("tf_op", "hlo_op", "name", "long_name",
                               "hlo_category"):
                        blob += f" {value} {scope_map.get(str(value), '')}"
                dur_ms = ev.duration_ns / 1e6
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                n_events += 1
                for s in STAGES:
                    if s in blob:
                        per[s] += dur_ms
                        break
                else:
                    other += dur_ms
        if spans:
            spans.sort()
            covered, end = 0.0, spans[0][0]
            for a, b in spans:
                if b > end:
                    covered += b - max(a, end)
                    end = b
            busy.append(covered / max(spans[-1][1] - spans[0][0], 1e-9))
    total = sum(per.values()) + other
    busy_share = sum(busy) / len(busy) if busy else float("nan")
    return per, other, total, n_events, busy_share


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default=None)
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--keep", action="store_true",
                    help="keep the trace dir (prints its path)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pathtracer_tpu import load_scene
    from pathtracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from pathtracer_tpu.engine.wavefront import render_chunk, zero_accum
    from pathtracer_tpu.utils.profiling import measure_stages

    overrides = {}
    if args.res:
        overrides["RES"] = [args.res, args.res]
    if args.depth:
        overrides["DEPTH"] = args.depth
    if args.scene is None:
        from pathtracer_tpu.scene.fixtures import scene_path
        args.scene = scene_path("cornell")
    scene, settings = load_scene(args.scene, overrides=overrides or None)
    print(f"scene: {args.scene} {settings.width}x{settings.height} "
          f"d{settings.trace_depth} bvh={settings.bvh_impl}", flush=True)

    # warm up (compile) outside the trace
    accum = render_chunk(scene, settings, zero_accum(settings), jnp.int32(1),
                         args.frames, 0, True)
    jax.block_until_ready(accum)

    tmpdir = tempfile.mkdtemp(prefix="ptrace_") if args.keep else None
    ctx_dir = tmpdir or tempfile.mkdtemp(prefix="ptrace_")
    with jax.profiler.trace(ctx_dir):
        accum = render_chunk(scene, settings, accum,
                             jnp.int32(1 + args.frames), args.frames, 0, True)
        jax.block_until_ready(accum)

    pbs = glob.glob(os.path.join(ctx_dir, "**", "*.xplane.pb"),
                    recursive=True)
    if not pbs:
        print("no .xplane.pb captured; isolated-jit table follows.")
        print(measure_stages(scene, settings).table())
        return
    # instruction -> named_scope map from the compiled module (cache hit:
    # the same shapes just ran)
    try:
        hlo = render_chunk.lower(
            scene, settings, zero_accum(settings), jnp.int32(1),
            args.frames, 0, True).compile().as_text()
        scope_map = hlo_scope_map(hlo)
    except Exception as e:   # keep the tool usable if lowering API shifts
        print(f"(no HLO scope map: {e})")
        scope_map = {}
    per, other, total, n_events, busy_share = stage_attribution(
        _load_profile(pbs[-1]), scope_map)
    if args.keep:
        print(f"trace dir: {ctx_dir}")
    if n_events == 0:
        # CPU traces have no device plane to attribute
        print("no GPU device ops in the trace — isolated-jit table follows.")
        for plane in _load_profile(pbs[-1]).planes:
            print(f"  plane {plane.name}: "
                  f"{[(ln.name, len(list(ln.events))) for ln in plane.lines]}")
        print(measure_stages(scene, settings).table())
        return

    print(f"\n=== In-situ stage attribution (fused frame x{args.frames}, "
          f"{n_events} device ops) ===")
    print(f"{'Stage':<16}{'ms/frame':>12}{'%':>8}")
    for s in STAGES:
        ms = per[s] / args.frames
        pct = 100.0 * per[s] / max(total, 1e-12)
        print(f"{s:<16}{ms:>12.3f}{pct:>7.1f}%")
    print(f"{'(unattributed)':<16}{other / args.frames:>12.3f}"
          f"{100.0 * other / max(total, 1e-12):>7.1f}%")
    print(f"{'TOTAL device':<16}{total / args.frames:>12.3f}")
    print(f"device busy share of the traced window: {busy_share:.4f}")

    print()
    print(measure_stages(scene, settings).table())


if __name__ == "__main__":
    main()
