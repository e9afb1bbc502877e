#!/usr/bin/env python
"""Interactive progressive viewer — the reference app's interactivity
(main.cpp:488-562) without a GL window.

LIVE mode (default on a TTY): raw-terminal (termios cbreak) keypress loop —
keys act IMMEDIATELY, no enter needed, and the render refines continuously
between keystrokes exactly like the reference's per-frame loop
(main.cpp:454-472): every pass through the loop polls input, restarts
accumulation if the camera changed (camchanged, main.cpp:423-452), runs a
chunk of iterations, and redraws. Holding a key orbits smoothly. The image
is drawn IN the terminal (kitty graphics protocol, iTerm2 inline image, or
truecolor half-block ANSI cells — auto-detected) and mirrored to a PNG.

Keys (reference bindings, main.cpp:488-562):
  a/d     orbit left/right   (left-drag theta)
  w/x     orbit up/down      (left-drag phi)
  q/e     zoom in/out        (right-drag)
  i/j/k/l pan lookAt         (middle-drag)
  r       re-center lookAt   (SPACE key equivalent)
  s       save a timestamped PNG (S key)
  ESC     save + exit

TYPED mode (--typed, or when stdin is not a TTY): the same commands typed +
enter, preview via the auto-rewritten PNG only — the scriptable fallback.

Usage: python viewer.py scenes/cornell.json [--res 256] [--out live.png]
       [--display auto|kitty|iterm2|ansi|file] [--typed]
"""
from __future__ import annotations

import argparse
import base64
import os
import select
import sys
import time


# ---------------------------------------------------------------------------
# Terminal display backends
# ---------------------------------------------------------------------------

def _png_bytes(img8):
    from pathtracer_tpu.io.image import encode_png
    return encode_png(img8)


def detect_display() -> str:
    term = os.environ.get("TERM", "")
    if os.environ.get("KITTY_WINDOW_ID") or "kitty" in term:
        return "kitty"
    if os.environ.get("ITERM_SESSION_ID") or "iTerm" in os.environ.get(
            "TERM_PROGRAM", ""):
        return "iterm2"
    if sys.stdout.isatty():
        return "ansi"
    return "file"


def show_kitty(img8) -> None:
    """Kitty graphics protocol: transmit + display a PNG in place."""
    payload = base64.standard_b64encode(_png_bytes(img8)).decode()
    out = sys.stdout
    out.write("\033[H")
    first = True
    while payload:
        chunk, payload = payload[:4096], payload[4096:]
        m = 1 if payload else 0
        ctrl = f"a=T,f=100,m={m}" if first else f"m={m}"
        out.write(f"\033_G{ctrl};{chunk}\033\\")
        first = False
    out.write("\n")
    out.flush()


def show_iterm2(img8) -> None:
    payload = base64.standard_b64encode(_png_bytes(img8)).decode()
    sys.stdout.write(f"\033[H\033]1337;File=inline=1:{payload}\a\n")
    sys.stdout.flush()


def show_ansi(img8, max_cols: int = 0) -> None:
    """Truecolor half-block cells: 2 vertical pixels per character row —
    works in any modern terminal with no graphics protocol."""
    import numpy as np
    h, w = img8.shape[:2]
    if not max_cols:
        try:
            tw, th = os.get_terminal_size()
        except OSError:
            tw, th = 80, 24
        max_cols = max(16, min(tw - 2, (th - 3) * 2 * w // max(h, 1)))
    step = max(1, (w + max_cols - 1) // max_cols)
    small = img8[::step, ::step]
    if small.shape[0] % 2:
        small = small[:-1]
    top, bot = small[0::2], small[1::2]
    lines = ["\033[H"]
    for rt, rb in zip(top, bot):
        row = []
        for (r1, g1, b1), (r2, g2, b2) in zip(rt, rb):
            row.append(f"\033[38;2;{r1};{g1};{b1}m"
                       f"\033[48;2;{r2};{g2};{b2}m▀")
        lines.append("".join(row) + "\033[0m")
    sys.stdout.write("\n".join(lines) + "\n")
    sys.stdout.flush()


def show(display: str, img8) -> None:
    if display == "kitty":
        show_kitty(img8)
    elif display == "iterm2":
        show_iterm2(img8)
    elif display == "ansi":
        show_ansi(img8)


# ---------------------------------------------------------------------------
# Raw-terminal key input
# ---------------------------------------------------------------------------

class RawKeys:
    """cbreak-mode stdin with non-blocking drain (restores on exit)."""

    def __enter__(self):
        import termios
        import tty
        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        return self

    def __exit__(self, *exc):
        import termios
        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def drain(self) -> str:
        """All pending keypresses (empty string if none)."""
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            keys.append(sys.stdin.read(1))
        return "".join(keys)


# ---------------------------------------------------------------------------
# Viewer
# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--out", type=str, default="live.png",
                    help="continuously-updated preview PNG")
    ap.add_argument("--spp-per-step", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--display", default="auto",
                    choices=["auto", "kitty", "iterm2", "ansi", "file"])
    ap.add_argument("--typed", action="store_true",
                    help="typed-command mode (no raw terminal)")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="exit after N refine steps (smoke testing)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (testing without a GPU)")
    args = ap.parse_args()

    import numpy as np

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from pathtracer_tpu import load_scene
    from pathtracer_tpu.utils.compile_cache import enable_compile_cache
    from pathtracer_tpu.engine.wavefront import (lanes_to_image, render_chunk,
                                                 zero_accum)
    from pathtracer_tpu.io.image import (reference_style_name, save_png,
                                         to_uint8)
    from pathtracer_tpu.scene.loader import derive_camera, orbit_camera

    enable_compile_cache()
    overrides = {"RES": [args.res, args.res]}
    if args.depth:
        overrides["DEPTH"] = args.depth
    scene, settings = load_scene(args.scene, overrides=overrides)

    display = detect_display() if args.display == "auto" else args.display
    typed = args.typed or not sys.stdin.isatty()

    # Orbit state from the loaded camera (main.cpp:359-381)
    cam = scene.camera
    pos = np.asarray(cam.position)
    look_at = np.asarray(settings.look_at, dtype=np.float64)
    offset = pos - look_at
    zoom = float(np.linalg.norm(offset))
    theta = float(np.arccos(np.clip(offset[1] / max(zoom, 1e-9), -1, 1)))
    phi = float(np.arctan2(offset[0], offset[2]))

    cam_dict = derive_camera(pos, look_at, np.asarray(cam.up),
                             settings.fovy_deg, settings.width,
                             settings.height,
                             float(cam.focal_distance), float(cam.lens_radius))
    home_look_at = look_at.copy()

    def rebuild_camera():
        """Recompute camera arrays from (zoom, theta, phi, look_at)."""
        nonlocal scene
        new_cam = orbit_camera(cam_dict, zoom, theta, phi, look_at)
        cam_arrays = scene.camera._replace(
            position=jnp.asarray(new_cam["position"], jnp.float32),
            view=jnp.asarray(new_cam["view"], jnp.float32),
            up=jnp.asarray(new_cam["up"], jnp.float32),
            right=jnp.asarray(new_cam["right"], jnp.float32),
        )
        scene = scene._replace(camera=cam_arrays)

    accum = zero_accum(settings)
    iteration = 0
    step_orbit = 0.15
    step_pan = 0.5
    last_ms = [0.0]

    def refine():
        nonlocal accum, iteration
        t0 = time.perf_counter()
        accum = render_chunk(scene, settings, accum, jnp.int32(iteration + 1),
                             args.spp_per_step, args.seed, True)
        jax.block_until_ready(accum)
        iteration += args.spp_per_step
        img = lanes_to_image(accum * (1.0 / iteration), settings)
        last_ms[0] = (time.perf_counter() - t0) * 1e3 / args.spp_per_step
        return img

    def restart():
        nonlocal accum, iteration
        accum = zero_accum(settings)
        iteration = 0

    def apply_key(cmd: str) -> str:
        """One keypress -> camera/orbit update. Returns 'moved', 'save',
        'quit' or '' (main.cpp:488-562 semantics)."""
        nonlocal phi, theta, zoom, look_at
        if cmd == "a":
            phi += step_orbit
        elif cmd == "d":
            phi -= step_orbit
        elif cmd == "w":
            theta = max(1e-3, theta - step_orbit)
        elif cmd == "x":
            theta = min(3.14, theta + step_orbit)
        elif cmd == "q":
            zoom = max(0.1, zoom - step_pan)
        elif cmd == "e":
            zoom += step_pan
        elif cmd == "i":
            look_at[1] += step_pan
        elif cmd == "k":
            look_at[1] -= step_pan
        elif cmd == "j":
            look_at[0] -= step_pan
        elif cmd == "l":
            look_at[0] += step_pan
        elif cmd == "r":
            look_at = home_look_at.copy()
        elif cmd == "s":
            return "save"
        elif cmd in ("\x1b", "quit", "exit"):
            return "quit"
        else:
            return ""
        return "moved"

    def save_timestamped(img):
        out = reference_style_name(settings.image_name, iteration)
        save_png(np.asarray(img), out)
        return out

    rebuild_camera()

    if typed:
        print(__doc__.split("Usage:")[0])
        img = refine()
        save_png(np.asarray(img), args.out)
        steps = 1
        while not (args.max_steps and steps >= args.max_steps):
            try:
                cmd = input("viewer> ").strip()
            except EOFError:
                cmd = "quit"
            act = apply_key(cmd)
            if act == "quit":
                print(f"  saved {save_timestamped(img)}")
                return
            if act == "save":
                print(f"  saved {save_timestamped(img)}")
            elif act == "moved":
                rebuild_camera()
                restart()       # camchanged -> restart accumulation
            img = refine()
            save_png(np.asarray(img), args.out)
            steps += 1
            print(f"  {iteration} spp  ({last_ms[0]:.1f} ms/frame)  "
                  f"-> {args.out}")
        return

    # LIVE raw-tty loop: poll keys -> (maybe) restart -> refine -> draw
    sys.stdout.write("\033[2J\033[H")   # clear once; frames repaint in place
    status = ""
    steps = 0
    with RawKeys() as keys:
        img = refine()
        while True:
            pressed = keys.drain()
            moved = False
            done = False
            for cmd in pressed:
                act = apply_key(cmd)
                if act == "quit":
                    done = True
                elif act == "save":
                    status = f"saved {save_timestamped(img)}"
                elif act == "moved":
                    moved = True
            if moved:
                rebuild_camera()
                restart()       # camchanged (main.cpp:423-452)
            img = refine()
            img8 = to_uint8(np.asarray(img))
            show(display, img8)
            sys.stdout.write(
                f"\033[K{iteration:6d} spp  {last_ms[0]:6.1f} ms/frame  "
                f"zoom {zoom:.1f}  [a/d w/x orbit, q/e zoom, ijkl pan, "
                f"r home, s save, ESC quit]  {status}\r")
            sys.stdout.flush()
            save_png(np.asarray(img), args.out)
            steps += 1
            if done or (args.max_steps and steps >= args.max_steps):
                print(f"\n  saved {save_timestamped(img)}")
                return


if __name__ == "__main__":
    main()
