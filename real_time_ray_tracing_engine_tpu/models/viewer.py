"""Interactive progressive viewer (terminal-native).

Terminal analogue of the reference's DynamicCamera SDL3 window
(DynamicCamera.cpp:66-348): progressive accumulation displayed live, WASD
camera movement that resets accumulation (:204-278), +/- samples-per-pixel
control (:239-252), an FPS/progress overlay with a convergence marker
(draw_fps, :308-348), and ESC/q to quit. Instead of an SDL window the frame
is drawn with ANSI truecolor half-block characters (two image rows per
terminal row), so it runs over ssh next to the accelerator — no display
stack needed.

Input handling degrades gracefully: when stdin is not a TTY the loop renders
non-interactively until convergence (or --frames).
"""
from __future__ import annotations

import os
import select
import shutil
import sys
import time

import numpy as np

from ..utils.color import to_bytes
from .render import ProgressiveRenderer

# WASD moves lookfrom+lookat by a fixed step, like the reference's
# handle_events (DynamicCamera.cpp:204-278; reference step = 10 units).
MOVE_STEP = 10.0
KEY_MOVES = {
    "w": (0.0, 0.0, -MOVE_STEP),
    "s": (0.0, 0.0, MOVE_STEP),
    "a": (-MOVE_STEP, 0.0, 0.0),
    "d": (MOVE_STEP, 0.0, 0.0),
}


def _downsample(img_bytes: np.ndarray, cols: int, rows: int) -> np.ndarray:
    """Nearest-neighbor resize of (H, W, 3) uint8 to (rows, cols, 3)."""
    h, w, _ = img_bytes.shape
    yi = np.minimum((np.arange(rows) * h) // rows, h - 1)
    xi = np.minimum((np.arange(cols) * w) // cols, w - 1)
    return img_bytes[yi[:, None], xi[None, :]]


def frame_to_ansi(img_bytes: np.ndarray, cols: int, rows: int) -> str:
    """(H, W, 3) uint8 -> ANSI truecolor half-block text of rows lines.

    Each terminal cell shows two vertically adjacent pixels: '▀' with the
    upper pixel as foreground and the lower as background."""
    small = _downsample(img_bytes, cols, rows * 2)
    top = small[0::2]
    bot = small[1::2]
    lines = []
    for r in range(rows):
        parts = []
        prev = None
        for c in range(cols):
            tr, tg, tb = top[r, c]
            br, bg, bb = bot[r, c]
            key = (tr, tg, tb, br, bg, bb)
            if key != prev:
                parts.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                             f"\x1b[48;2;{br};{bg};{bb}m")
                prev = key
            parts.append("▀")
        parts.append("\x1b[0m")
        lines.append("".join(parts))
    return "\n".join(lines)


class AdaptiveWork:
    """FPS-keyed work controller: the analogue of the reference's adaptive
    tile resizing (DynamicCamera.cpp:190-193, constants DynamicCamera.hpp:
    32-34 — tile halves under 15 FPS, doubles above 30, bounded 16-64).
    Here the per-frame work unit is samples-per-step: more strata per fused
    pass when the frame rate has headroom (regeneration amortizes dead
    lanes, so bigger steps are more efficient), fewer when interactivity
    would suffer. Hold the interactive band by halving k under FPS_LO and
    doubling above FPS_HI, clamped to [1, cap]."""
    FPS_LO = 15.0
    FPS_HI = 30.0

    def __init__(self, cap: int = 16):
        self.k = 1
        self.cap = cap

    def update(self, fps: float) -> int:
        if fps < self.FPS_LO:
            self.k = max(1, self.k // 2)
        elif fps > self.FPS_HI:
            self.k = min(self.cap, self.k * 2)
        return self.k


class _RawKeys:
    """Non-blocking single-key reads; no-op when stdin is not a TTY."""

    def __init__(self):
        self.enabled = sys.stdin.isatty()
        self._saved = None

    def __enter__(self):
        if self.enabled:
            import termios
            import tty
            self._saved = termios.tcgetattr(sys.stdin.fileno())
            tty.setcbreak(sys.stdin.fileno())
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            import termios
            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN,
                              self._saved)

    def poll(self) -> str | None:
        if not self.enabled:
            return None
        r, _, _ = select.select([sys.stdin], [], [], 0)
        if not r:
            return None
        ch = sys.stdin.read(1)
        if ch != "\x1b":
            return ch
        # ESC may start a terminal sequence (arrow keys = "\x1b[A"...):
        # drain any immediately-following bytes and only report a lone ESC,
        # so arrow keys neither quit the viewer nor leave "[A" bytes behind
        # to be misread as later WASD input.
        seq = ""
        while select.select([sys.stdin], [], [], 0.01)[0]:
            seq += sys.stdin.read(1)
        return ch if not seq else None


def run_viewer(scene, *, use_bvh: bool = False, seed: int = 0,
               max_frames: int | None = None,
               checkpoint: str | None = None, adaptive: bool = True,
               out=sys.stdout) -> "ProgressiveRenderer":
    """Progressive render loop with live terminal display and WASD input.

    adaptive=True scales samples-per-step from the measured FPS
    (AdaptiveWork — the reference's tile-resizing analogue,
    DynamicCamera.cpp:190-193). Returns the ProgressiveRenderer
    (accumulation state) at exit."""
    prog = ProgressiveRenderer(scene, use_bvh=use_bvh, seed=seed)
    if checkpoint and os.path.exists(checkpoint):
        prog.load(checkpoint)

    cols, rows = shutil.get_terminal_size((80, 24))
    view_rows = max(rows - 2, 4)
    out.write("\x1b[2J")                      # clear once
    frames = 0
    t_frame = time.time()
    fps = 0.0
    ctrl = AdaptiveWork()
    try:
        with _RawKeys() as keys:
            while True:
                did = prog.step(ctrl.k if adaptive else 1)
                frames += 1
                now = time.time()
                fps = 0.8 * fps + 0.2 / max(now - t_frame, 1e-9)
                t_frame = now
                if adaptive and frames > 1:
                    ctrl.update(fps)

                # terminal-resolution frame computed ON DEVICE: only the
                # displayed bytes cross to the host, not the float image
                img = prog.preview(cols, view_rows * 2)
                out.write("\x1b[H")           # cursor home
                out.write(frame_to_ansi(img, cols, view_rows))
                conv = " [Converged ✓]" if prog.converged else ""
                total = prog.n_strata ** 2
                out.write(f"\n\x1b[K{fps:5.1f} fps  sample "
                          f"{prog.samples_taken}/{total}{conv}  "
                          f"(wasd move, +/- spp, q quit)\n")
                out.flush()

                key = keys.poll()
                if key in ("q", "\x1b"):
                    break
                if key in KEY_MOVES:          # move + reset accumulation
                    prog.move_camera(KEY_MOVES[key])
                elif key == "+":
                    prog.set_spp((prog.n_strata + 1) ** 2)
                elif key == "-":
                    prog.set_spp(max(1, prog.n_strata - 1) ** 2)
                if max_frames is not None and frames >= max_frames:
                    break
                if not did and not keys.enabled:
                    break                     # converged, non-interactive
                if not did:
                    time.sleep(0.05)          # converged: poll keys only
    finally:
        if checkpoint:
            prog.save(checkpoint)
    return prog
