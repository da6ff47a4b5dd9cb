"""Interactive terminal viewer: fly camera + live parameter surface.

JAX replacement for the reference's interactive shell — Win32 window
+ message pump (/root/reference/src/utils/Win32Application.cpp), DirectInput
polling (libs/MiniEngine/GameInput.cpp), imgui parameter panels
(src/ProgressiveRaytracingPipeline.cpp:249-312) and the fps/MRays title bar
(src/utils/DXSample.cpp:100-123).

The "swapchain" is the terminal: frames are drawn with 24-bit ANSI
half-blocks (two pixels per character cell), input is raw-mode keyboard
polling. Works over ssh, no GUI stack required; for screenshots press 'p'.

Keys:
  w/a/s/d/q/e  move      i/j/k/l or arrows  look    space  reset accumulation
  mouse drag   look (xterm SGR mouse reporting; works over ssh)
  Alt-Enter    fullscreen toggle (fit-to-terminal <-> windowed size)
  [ / ]        switch pipeline (progressive <-> realtime+denoise)
  1..7         AOV debug view (off, albedo, direct, ind-diffuse,
               ind-specular, fresnel, AO)
  c            toggle cosine hemisphere sampling
  g            cycle debug int (0/1/2 light-MC)
  - / +        environment strength
  m / M        halve / double progressive max iterations
  n / N        denoiser kernel radius - / +
  t            denoiser tonemap toggle     o / O  exposure - / +
  r / R        material 0 roughness - / +        (accumulation restarts)
  f / F        material 0 reflectivity - / +
  b / B        material 0 albedo darker / brighter
  u / U        directional light intensity - / +
  y / Y        point light intensity - / +
  h / H        cycle directional / point light color
  p            save PNG screenshot   x  quit

Live terminal resize re-creates output resources each frame (parity with
WM_SIZE handling, /root/reference/src/DXRExperimentsApp.cpp:257-271).
Material/light edits mirror the reference's imgui sliders with the
frameDirty accumulation restart
(/root/reference/src/ProgressiveRaytracingPipeline.cpp:253-267,309-311).
"""

from __future__ import annotations

import dataclasses
import os
import select
import sys
import termios
import time
import tty

import jax.numpy as jnp
import numpy as np

from ..core.camera import Camera
from ..core.camera_controller import CameraController, InputState
from ..core.timer import StepTimer
from ..models.denoise import DenoiseCompositor, linear_to_srgb, reinhard_tonemap
from ..models.progressive import ProgressiveRaytracingPipeline
from ..models.realtime import RealtimeRaytracingPipeline
from ..scene.materials import Material
from ..scene.scene import rebake_material
from ..utils.runtime import PLATFORMS, enable_compile_cache, select_platform
from ..utils.image import write_png
from ..utils.stats import FrameStats
from .headless import build_scene

LIGHT_PALETTE = [
    (1.0, 1.0, 1.0),
    (1.0, 0.85, 0.6),
    (0.6, 0.75, 1.0),
    (1.0, 0.4, 0.4),
    (0.5, 1.0, 0.6),
]

AOV_KEYS = {
    "2": "show_gbuffer_albedo_only",
    "3": "show_direct_lighting_only",
    "4": "show_indirect_diffuse_only",
    "5": "show_indirect_specular_only",
    "6": "show_fresnel_term",
}


class TerminalDisplay:
    """ANSI half-block framebuffer presenter (the swapchain/blit analogue,
    cf. BlitToBackbuffer /root/reference/src/DXRExperimentsApp.cpp:273-285)."""

    def __init__(self, out=sys.stdout):
        self.out = out

    def size(self) -> tuple[int, int]:
        try:
            c = os.get_terminal_size()
            return max(c.columns - 2, 16), max((c.lines - 4) * 2, 16)
        except OSError:
            return 80, 44

    def present(self, img: np.ndarray, hud: str) -> None:
        """img: [H, W, 3] float 0..1, H even."""
        q = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
        top = q[0::2]
        bottom = q[1::2]
        lines = []
        for t_row, b_row in zip(top, bottom):
            cells = [
                f"\x1b[38;2;{tr[0]};{tr[1]};{tr[2]}m\x1b[48;2;{br[0]};{br[1]};{br[2]}m▀"
                for tr, br in zip(t_row, b_row)
            ]
            lines.append("".join(cells) + "\x1b[0m")
        frame = "\x1b[H" + "\n".join(lines) + "\x1b[0m\n" + hud + "\x1b[K"
        self.out.write(frame)
        self.out.flush()


class KittyDisplay:
    """Pixel-accurate presenter via the kitty graphics protocol.

    Where TerminalDisplay quantizes to character-cell half-blocks, this
    transmits the actual framebuffer (raw RGB, base64, chunked escape
    sequences) so terminals speaking the kitty protocol (kitty, ghostty,
    wezterm, konsole) present every rendered pixel — the terminal analogue
    of the reference's windowed swapchain present
    (/root/reference/src/utils/Win32Application.cpp:49-62 +
    DXRExperimentsApp.cpp:273-285 BlitToBackbuffer). Auto-selected when the
    terminal advertises the protocol; ``--display`` overrides.
    """

    CHUNK = 4096  # max base64 payload bytes per escape chunk (protocol cap)

    def __init__(self, out=sys.stdout, max_dim: int = 640):
        self.out = out
        self.max_dim = max_dim

    @staticmethod
    def supported() -> bool:
        return bool(
            os.environ.get("KITTY_WINDOW_ID")
            or "kitty" in os.environ.get("TERM", "")
            or "ghostty" in os.environ.get("TERM", "")
        )

    def size(self) -> tuple[int, int]:
        """Render size in PIXELS (the cell-pixel area reported by the tty)."""
        try:
            import fcntl
            import struct as _struct
            import termios

            ws = fcntl.ioctl(
                self.out.fileno(), termios.TIOCGWINSZ, b"\x00" * 8
            )
            rows, cols, xpix, ypix = _struct.unpack("HHHH", ws)
        except (OSError, ValueError, ImportError):
            rows = cols = xpix = ypix = 0
        if xpix <= 0 or ypix <= 0:
            # Terminal didn't report pixel size: assume 8x16-px cells.
            cols = cols or 80
            rows = rows or 24
            xpix, ypix = cols * 8, rows * 16
        # Leave 2 text rows for the HUD below the image.
        ypix = max(ypix - 2 * max(ypix // max(rows, 1), 16), 32)
        w = min(xpix, self.max_dim)
        h = min(ypix, self.max_dim)
        return max(w, 16), max(h - h % 2, 16)

    def present(self, img: np.ndarray, hud: str) -> None:
        """img: [H, W, 3] float 0..1 — transmitted losslessly (8-bit)."""
        import base64

        q = np.ascontiguousarray(
            np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
        )
        h, w = q.shape[:2]
        payload = base64.standard_b64encode(q.tobytes())
        parts = []
        # i=1: a stable image id so each frame REPLACES the previous one
        # (no per-frame image accumulation in the terminal).
        ctrl = f"a=T,f=24,s={w},v={h},i=1,q=2"
        first = True
        for off in range(0, len(payload), self.CHUNK):
            chunk = payload[off : off + self.CHUNK].decode("ascii")
            more = 1 if off + self.CHUNK < len(payload) else 0
            head = f"{ctrl},m={more}" if first else f"m={more}"
            parts.append(f"\x1b_G{head};{chunk}\x1b\\")
            first = False
        frame = "\x1b[H" + "".join(parts) + "\n" + hud + "\x1b[K"
        self.out.write(frame)
        self.out.flush()


class RawKeyboard:
    """Non-blocking raw-mode keyboard + mouse polling (GameInput analogue).

    Beyond plain keys, parses the escape stream for:
      * SGR mouse reports (xterm ?1002/?1006 — drag-to-look over ssh, the
        terminal analogue of the reference's relative mouse-look,
        /root/reference/libs/MiniEngine/GameInput.cpp:303-330): drags emit
        ("mouse", dx, dy) cell-delta events.
      * Arrow keys -> the i/j/k/l look taps.
      * Alt-Enter -> "ALT_ENTER" (the reference's borderless-fullscreen
        toggle, /root/reference/src/utils/Win32Application.cpp:98-173).
    """

    MOUSE_ON = "\x1b[?1002h\x1b[?1006h"
    MOUSE_OFF = "\x1b[?1006l\x1b[?1002l"
    _ARROWS = {"A": "i", "B": "k", "C": "l", "D": "j"}

    def __init__(self, mouse: bool = True):
        self.enabled = sys.stdin.isatty()
        self.mouse = mouse and self.enabled
        self._old = None
        self._drag_from = None  # (x, y) of the last drag report

    def __enter__(self):
        if self.enabled:
            self._old = termios.tcgetattr(sys.stdin)
            tty.setcbreak(sys.stdin.fileno())
        if self.mouse:
            sys.stdout.write(self.MOUSE_ON)
            sys.stdout.flush()
        return self

    def __exit__(self, *exc):
        if self.mouse:
            sys.stdout.write(self.MOUSE_OFF)
            sys.stdout.flush()
        if self._old is not None:
            termios.tcsetattr(sys.stdin, termios.TCSADRAIN, self._old)

    def _read_pending(self) -> str:
        data = []
        while select.select([sys.stdin], [], [], 0)[0]:
            data.append(sys.stdin.read(1))
        return "".join(data)

    def parse(self, data: str) -> list:
        """Escape-stream parser -> event list: plain key strings,
        "ALT_ENTER", or ("mouse", dx, dy) drag deltas. Pure (testable)."""
        events: list = []
        i = 0
        n = len(data)
        while i < n:
            ch = data[i]
            if ch != "\x1b":
                events.append(ch)
                i += 1
                continue
            # escape sequence
            if i + 1 < n and data[i + 1] in ("\r", "\n"):
                events.append("ALT_ENTER")
                i += 2
                continue
            if i + 2 < n and data[i + 1] == "[":
                c2 = data[i + 2]
                if c2 in self._ARROWS:
                    events.append(self._ARROWS[c2])
                    i += 3
                    continue
                if c2 == "<":  # SGR mouse: ESC [ < b ; x ; y (M|m)
                    j = i + 3
                    while j < n and data[j] not in "Mm":
                        j += 1
                    if j >= n:
                        break  # truncated; drop
                    try:
                        b, x, y = (int(v) for v in data[i + 3 : j].split(";"))
                    except ValueError:
                        i = j + 1
                        continue
                    press = data[j] == "M"
                    if b & 32 and self._drag_from is not None:
                        # motion with button held: emit the cell delta
                        dx = x - self._drag_from[0]
                        dy = y - self._drag_from[1]
                        if dx or dy:
                            events.append(("mouse", dx, dy))
                        self._drag_from = (x, y)
                    elif press and (b & 3) != 3:
                        self._drag_from = (x, y)
                    else:  # release
                        self._drag_from = None
                    i = j + 1
                    continue
            i += 1  # bare ESC or unknown sequence: skip
        return events

    def poll(self) -> list:
        if not self.enabled:
            return []
        return self.parse(self._read_pending())


class ViewerApp:
    """The app orchestrator (DXRExperimentsApp analogue)."""

    def __init__(self, scene_name="cornell-glossy", width=128, height=96,
                 accel="auto", animate_instances=False):
        self.scene, self.camera = build_scene(scene_name)
        self.camera.set_aspect(width, height)
        self.width, self.height = width, height
        self.windowed_size = (width, height)
        self.fit_terminal = False  # main() sets the launch mode
        self.controller = CameraController(self.camera)
        self.controller.first_person_mouse = True  # drag-to-look
        self.timer = StepTimer()
        self.stats = FrameStats(width, height)
        self.animate_instances = animate_instances
        self.pipelines = [
            ProgressiveRaytracingPipeline(width, height, seed=0),
            RealtimeRaytracingPipeline(width, height, seed=0),
        ]
        two_level = accel == "two-level" or animate_instances
        scene_data = self.scene.build_two_level() if two_level else None
        for p in self.pipelines:
            p.set_camera(self.camera)
            if scene_data is not None:
                p.set_scene_data(scene_data)
            else:
                p.set_scene(self.scene)
        self._base_transforms = (
            np.stack([inst.transform for inst in self.scene.instances])
            if animate_instances
            else None
        )
        self.active = 0
        self.denoiser = DenoiseCompositor()
        self.env_strength = 1.0
        self.aov = None
        self.ao_only = False
        self.screenshot_counter = 0
        self.message = ""
        # host-side copy of material 0 for live editing (the reference's
        # imgui material panel edits material 0 only)
        self.mat0 = (
            dataclasses.replace(self.scene.materials[0])
            if self.scene.materials
            else Material()
        )
        self._palette_idx = {"dir": 0, "point": 0}

    @property
    def pipeline(self):
        return self.pipelines[self.active]

    # radians per terminal cell of mouse drag (drag-to-look)
    MOUSE_CELL_SCALE = 0.03

    def handle_keys(self, keys: list) -> tuple[InputState, bool]:
        inp = InputState()
        quit_requested = False
        pipe = self.pipeline
        for k in keys:
            if isinstance(k, tuple) and k[0] == "mouse":
                # drag-to-look: cell deltas -> first-person mouse radians
                # (bypasses momentum, CameraController.cpp:96-101)
                inp.mouse_dx += k[1] * self.MOUSE_CELL_SCALE
                inp.mouse_dy += -k[2] * self.MOUSE_CELL_SCALE
            elif k == "ALT_ENTER":
                # borderless-fullscreen analogue: toggle fit-to-terminal
                # (Win32Application.cpp:98-173)
                self.fit_terminal = not self.fit_terminal
                self.message = (
                    "fullscreen (fit terminal)" if self.fit_terminal
                    else "windowed"
                )
            elif k == "x":
                quit_requested = True
            elif k == "w":
                inp.forward = True
            elif k == "s":
                inp.backward = True
            elif k == "a":
                inp.strafe_left = True
            elif k == "d":
                inp.strafe_right = True
            elif k == "e":
                inp.ascend = True
            elif k == "q":
                inp.descend = True
            elif k == "j":
                inp.analog_yaw = -0.6
            elif k == "l":
                inp.analog_yaw = 0.6
            elif k == "i":
                inp.analog_pitch = 0.35
            elif k == "k":
                inp.analog_pitch = -0.35
            elif k in "[]":
                self.active = (self.active + (1 if k == "]" else -1)) % len(
                    self.pipelines
                )
                self.message = f"pipeline: {self.pipeline.name}"
            elif k == " ":
                if hasattr(pipe, "mark_dirty"):
                    pipe.mark_dirty()
            elif k == "1":
                self.aov = None
                self.ao_only = False
                self._apply_aov()
            elif k in AOV_KEYS:
                self.aov = AOV_KEYS[k]
                self.ao_only = False
                self._apply_aov()
            elif k == "7":
                self.ao_only = True
                self.aov = None
                self._apply_aov()
            elif k == "c":
                cur = bool(pipe.options["cosine_hemisphere_sampling"])
                pipe.options["cosine_hemisphere_sampling"] = jnp.asarray(not cur)
                self._dirty()
                self.message = f"cosine sampling: {not cur}"
            elif k == "z":
                # refraction toggle (beyond-reference transmission bounce;
                # static flag -> the progressive step recompiles)
                if hasattr(pipe, "refraction"):
                    pipe.refraction = not pipe.refraction
                    self._dirty()
                    self.message = f"refraction: {pipe.refraction}"
            elif k == "g":
                cur = int(pipe.options["debug"])
                pipe.options["debug"] = jnp.asarray((cur + 1) % 3, jnp.int32)
                self._dirty()
                self.message = f"debug mode: {(cur + 1) % 3}"
            elif k in "-_":
                self._env_scale(1.0 / 1.25)
            elif k in "+=":
                self._env_scale(1.25)
            elif k in "mM":
                for p2 in self.pipelines:
                    if hasattr(p2, "max_iterations"):
                        p2.max_iterations = max(
                            1,
                            p2.max_iterations * 2 if k == "M" else p2.max_iterations // 2,
                        )
                        self.message = f"max iterations: {p2.max_iterations}"
            elif k in "nN":
                cur = int(self.denoiser.params["max_kernel_size"])
                cur = min(25, cur + 1) if k == "N" else max(1, cur - 1)
                self.denoiser.params["max_kernel_size"] = jnp.asarray(cur, jnp.int32)
                self.message = f"denoise kernel: {cur}"
            elif k == "t":
                cur = bool(self.denoiser.params["tonemap"])
                self.denoiser.params["tonemap"] = jnp.asarray(not cur)
                self.message = f"tonemap: {not cur}"
            elif k in "oO":
                cur = float(self.denoiser.params["exposure"])
                cur = cur * 1.25 if k == "O" else cur / 1.25
                self.denoiser.params["exposure"] = jnp.asarray(cur, jnp.float32)
                self.message = f"exposure: {cur:.2f}"
            elif k in "rR":
                self._edit_material(
                    "roughness", lambda v: min(1.0, max(0.0, v + (0.1 if k == "R" else -0.1)))
                )
            elif k in "fF":
                self._edit_material(
                    "reflectivity", lambda v: min(1.0, max(0.0, v + (0.1 if k == "F" else -0.1)))
                )
            elif k in "bB":
                s = 1.25 if k == "B" else 1.0 / 1.25
                self._edit_material(
                    "albedo",
                    lambda a: tuple(min(c * s, 1.0) for c in a[:3]) + (a[3],),
                )
            elif k in "uU":
                self._edit_light("dir", scale=1.25 if k == "U" else 1 / 1.25)
            elif k in "yY":
                self._edit_light("point", scale=1.25 if k == "Y" else 1 / 1.25)
            elif k in "hH":
                which = "dir" if k == "h" else "point"
                self._palette_idx[which] = (self._palette_idx[which] + 1) % len(
                    LIGHT_PALETTE
                )
                self._edit_light(
                    which, color=LIGHT_PALETTE[self._palette_idx[which]]
                )
            elif k == "p":
                self.screenshot_counter += 1
                path = f"screenshot_{self.screenshot_counter:03d}.png"
                write_png(path, self._display_image())
                self.message = f"saved {path}"
        return inp, quit_requested

    def _dirty(self):
        for p in self.pipelines:
            if hasattr(p, "mark_dirty"):
                p.mark_dirty()

    def _edit_material(self, field: str, fn) -> None:
        """Edit material 0 and re-bake the material table — the
        imgui material sliders + frameDirty restart
        (/root/reference/src/ProgressiveRaytracingPipeline.cpp:253-267)."""
        self.mat0 = dataclasses.replace(
            self.mat0, **{field: fn(getattr(self.mat0, field))}
        )
        for p in self.pipelines:
            p.scene_data = rebake_material(p.scene_data, 0, self.mat0)
        self._dirty()
        val = getattr(self.mat0, field)
        self.message = (
            f"material[0].{field}: "
            + (f"{val:.2f}" if isinstance(val, float) else f"{tuple(round(v, 2) for v in val)}")
        )

    def _edit_light(self, which: str, scale: float | None = None, color=None):
        """Light color/intensity edits (the reference's two light panels,
        ProgressiveRaytracingPipeline.cpp:253-258). Lights are per-frame
        args, so no recompile — just the dirty accumulation restart."""
        for p in self.pipelines:
            lights = {k: dict(v) for k, v in p.scene_data["lights"].items()}
            lt = lights[which]
            if scale is not None:
                lt["intensity"] = jnp.asarray(
                    float(lt["intensity"]) * scale, jnp.float32
                )
            if color is not None:
                lt["color"] = jnp.asarray(color, jnp.float32)
            p.scene_data = dict(p.scene_data, lights=lights)
        self._dirty()
        lt = self.pipeline.scene_data["lights"][which]
        self.message = (
            f"{which} light: intensity {float(lt['intensity']):.2f}, "
            f"color {tuple(round(float(c), 2) for c in np.asarray(lt['color']))}"
        )

    def resize(self, width: int, height: int) -> None:
        """Re-create output resources on size change (WM_SIZE parity,
        /root/reference/src/DXRExperimentsApp.cpp:257-271)."""
        if (width, height) == (self.width, self.height):
            return
        self.width, self.height = width, height
        self.camera.set_aspect(width, height)
        for p in self.pipelines:
            p.create_output_resource(width, height)
        self.denoiser.reset_history()
        self.stats = FrameStats(width, height)
        self.message = f"resized to {width}x{height}"

    def _env_scale(self, f):
        self._set_env_strength(self.env_strength * f)
        self.message = f"env strength: {self.env_strength:.2f}"

    def _set_env_strength(self, v: float) -> None:
        self.env_strength = v
        for p in self.pipelines:
            env = dict(p.scene_data["env"])
            env["strength"] = jnp.asarray(self.env_strength, jnp.float32)
            p.scene_data = dict(p.scene_data, env=env)
        self._dirty()

    # -- UI state persistence (the reference persists its imgui panel layout
    # in vc2015/imgui.ini across sessions; this is the key-param analogue:
    # every toggle the viewer's "panel" exposes survives a relaunch) -------
    def ui_state(self) -> dict:
        pipe0 = self.pipelines[0]
        return {
            "active": self.active,
            "aov": self.aov,
            "ao_only": self.ao_only,
            "env_strength": self.env_strength,
            "debug": int(pipe0.options["debug"]),
            "cosine": bool(pipe0.options["cosine_hemisphere_sampling"]),
            "max_iterations": int(
                getattr(pipe0, "max_iterations", 0) or 0
            ),
            "denoise": {
                "max_kernel_size": int(self.denoiser.params["max_kernel_size"]),
                "tonemap": bool(self.denoiser.params["tonemap"]),
                "exposure": float(self.denoiser.params["exposure"]),
            },
            "mat0": {
                "roughness": float(self.mat0.roughness),
                "reflectivity": float(self.mat0.reflectivity),
                "albedo": [float(c) for c in self.mat0.albedo],
            },
            "lights": {
                name: {
                    "intensity": float(lt["intensity"]),
                    "color": [float(c) for c in np.asarray(lt["color"])],
                }
                for name, lt in self.pipeline.scene_data.get(
                    "lights", {}
                ).items()
            },
        }

    def apply_ui_state(self, state: dict) -> None:
        """Restore a ui_state() snapshot through the SAME application paths
        the key handlers use (AOV options, denoiser params, material
        re-bake, light args), so a restored session renders identically to
        the one that saved it."""
        self.active = int(state.get("active", 0)) % len(self.pipelines)
        self.aov = state.get("aov")
        self.ao_only = bool(state.get("ao_only", False))
        self._apply_aov()
        if "env_strength" in state:
            self._set_env_strength(float(state["env_strength"]))
        for p in self.pipelines:
            p.options["debug"] = jnp.asarray(
                int(state.get("debug", 0)), jnp.int32
            )
            p.options["cosine_hemisphere_sampling"] = jnp.asarray(
                bool(state.get("cosine", True))
            )
            if state.get("max_iterations") and hasattr(p, "max_iterations"):
                p.max_iterations = int(state["max_iterations"])
        dn = state.get("denoise", {})
        if dn:
            self.denoiser.params["max_kernel_size"] = jnp.asarray(
                int(dn["max_kernel_size"]), jnp.int32
            )
            self.denoiser.params["tonemap"] = jnp.asarray(bool(dn["tonemap"]))
            self.denoiser.params["exposure"] = jnp.asarray(
                float(dn["exposure"]), jnp.float32
            )
        m0 = state.get("mat0")
        if m0 and self.scene.materials:
            alb = tuple(m0["albedo"]) + (
                () if len(m0["albedo"]) == 4 else (self.mat0.albedo[3],)
            )
            self.mat0 = dataclasses.replace(
                self.mat0,
                roughness=float(m0["roughness"]),
                reflectivity=float(m0["reflectivity"]),
                albedo=alb,
            )
            for p in self.pipelines:
                p.scene_data = rebake_material(p.scene_data, 0, self.mat0)
        for name, lt_s in state.get("lights", {}).items():
            for p in self.pipelines:
                lights = {k: dict(v) for k, v in p.scene_data["lights"].items()}
                if name not in lights:
                    continue
                lights[name]["intensity"] = jnp.asarray(
                    float(lt_s["intensity"]), jnp.float32
                )
                lights[name]["color"] = jnp.asarray(
                    lt_s["color"], jnp.float32
                )
                p.scene_data = dict(p.scene_data, lights=lights)
        self._dirty()
        self.message = "restored UI state"

    def save_ui_state(self, path: str) -> None:
        import json

        with open(path, "w") as f:
            json.dump(self.ui_state(), f, indent=1)

    def load_ui_state(self, path: str) -> bool:
        import json
        import os

        if not os.path.exists(path):
            return False
        with open(path) as f:
            self.apply_ui_state(json.load(f))
        return True

    def _apply_aov(self):
        for p in self.pipelines:
            for key in AOV_KEYS.values():
                p.options[key] = jnp.asarray(key == self.aov)
            if hasattr(p, "ao_only"):
                p.ao_only = self.ao_only
        self._dirty()
        self.message = f"view: {self.aov or ('AO' if self.ao_only else 'beauty')}"

    def step(self, inp: InputState) -> np.ndarray:
        self.timer.tick()
        dt = max(self.timer.elapsed_seconds, 1e-4)
        vp_before = self.camera.view_proj_matrix()
        self.controller.update(dt, inp)
        if not np.array_equal(vp_before, self.camera.view_proj_matrix()):
            self.denoiser.reset_history()  # avoid temporal ghosting
        pipe = self.pipeline
        if self._base_transforms is not None and hasattr(
            pipe, "set_instance_transforms"
        ):
            # spin instance transforms via TLAS refit (no re-bake/recompile)
            yaw = 0.4 * self.timer.total_seconds
            c, s = np.cos(yaw), np.sin(yaw)
            rot = np.eye(4, dtype=np.float32)
            rot[0, 0], rot[0, 2], rot[2, 0], rot[2, 2] = c, s, -s, c
            pipe.set_instance_transforms(
                jnp.asarray(np.einsum("ij,njk->nik", rot, self._base_transforms))
            )
        pipe.update(
            elapsed_time=self.timer.total_seconds,
            elapsed_frames=self.timer.frame_count,
        )
        pipe.render()
        self.stats.frame()
        return self._display_image()

    def _display_image(self) -> np.ndarray:
        pipe = self.pipeline
        if isinstance(pipe, RealtimeRaytracingPipeline):
            img = self.denoiser.dispatch(pipe.direct, pipe.indirect_specular)
        else:
            img = linear_to_srgb(
                reinhard_tonemap(pipe.get_output()), jnp.asarray(2.2)
            )
        return np.clip(np.asarray(img), 0.0, 1.0)

    def hud(self) -> str:
        pipe = self.pipeline
        prog = ""
        if isinstance(pipe, ProgressiveRaytracingPipeline):
            frac = min(pipe.accum_count / max(pipe.max_iterations, 1), 1.0)
            bar = "#" * int(frac * 20)
            prog = f" [{bar:<20}] {pipe.accum_count}"
        return (
            f"{self.stats.title()} | {pipe.name}{prog} | {self.message}   "
            "(wasdqe move, ijkl look, 1-7 views, x quit)"
        )


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default="cornell-glossy")
    ap.add_argument("--size", default=None, help="WxH render size (default: fit terminal)")
    ap.add_argument(
        "--platform", default=None, choices=PLATFORMS,
        help="run on this JAX platform or fail (default: JAX's own choice)",
    )
    ap.add_argument("--max-frames", type=int, default=0, help="exit after N frames (0 = run until 'x')")
    ap.add_argument("--script", default=None, help="scripted key sequence (for testing), e.g. 'wwwd p x'")
    ap.add_argument(
        "--accel", default="auto", choices=["auto", "two-level"],
        help="acceleration structure (see headless --accel)",
    )
    ap.add_argument(
        "--animate-instances", action="store_true",
        help="spin instance transforms each frame via TLAS refit",
    )
    ap.add_argument(
        "--display", default="auto", choices=["auto", "ansi", "kitty"],
        help="presenter: ANSI half-blocks or pixel-accurate kitty graphics "
             "(auto picks kitty when the terminal advertises it)",
    )
    ap.add_argument(
        "--gamepad", nargs="?", const="", default=None, metavar="PATH",
        help="enable analog gamepad input (/dev/input/js*; optional "
             "explicit device path)",
    )
    ap.add_argument(
        "--ui-state", default=None, metavar="PATH",
        help="persist viewer params (AOV, denoiser, material/light edits, "
             "env strength) across sessions — the imgui.ini analogue "
             "(default ~/.dxrexperiments_tpu/viewer_ui.json)",
    )
    ap.add_argument(
        "--no-ui-state", action="store_true",
        help="disable UI state persistence",
    )
    ap.add_argument(
        "--auto-checkpoint", default=None, metavar="PATH",
        help="periodically save the progressive accumulation state, and "
             "rebuild+restore in-session if a render step dies — the "
             "device-lost recovery analogue "
             "(DeviceResources.cpp:447-487, IDeviceNotify)",
    )
    ap.add_argument(
        "--checkpoint-every-sec", type=float, default=30.0,
        help="auto-checkpoint period in seconds (0 = every frame)",
    )
    args = ap.parse_args(argv)

    try:
        select_platform(args.platform)
    except RuntimeError as e:
        ap.error(str(e))
    enable_compile_cache()

    use_kitty = args.display == "kitty" or (
        args.display == "auto" and KittyDisplay.supported()
    )
    display = KittyDisplay() if use_kitty else TerminalDisplay()

    pad = None
    if args.gamepad is not None:
        from ..core.gamepad import Gamepad

        pad = Gamepad.open(args.gamepad or None)
        if pad is None:
            print("viewer: no gamepad device found", file=sys.stderr)

    if args.size:
        width, height = (int(x) for x in args.size.lower().split("x"))
    elif use_kitty:
        width, height = display.size()
    else:
        width, height = display.size()
        width, height = min(width, 200), min(height - height % 2, 140)

    def make_app():
        a = ViewerApp(args.scene, width, height, accel=args.accel,
                      animate_instances=args.animate_instances)
        a.fit_terminal = args.size is None
        return a

    app = make_app()
    ui_path = None
    if not args.no_ui_state:
        ui_path = args.ui_state or os.path.join(
            os.path.expanduser("~"), ".dxrexperiments_tpu", "viewer_ui.json"
        )
        os.makedirs(os.path.dirname(ui_path) or ".", exist_ok=True)
        try:
            if app.load_ui_state(ui_path):
                print(f"viewer: restored UI state from {ui_path}",
                      file=sys.stderr)
        except Exception as e:  # a stale/corrupt file must never block launch
            print(f"viewer: ignoring UI state ({e})", file=sys.stderr)
    scripted = list(args.script.replace(" ", "")) if args.script else None

    use_alt_screen = sys.stdout.isatty()
    if use_alt_screen:
        sys.stdout.write("\x1b[?1049h")  # alternate screen buffer
    sys.stdout.write("\x1b[2J")  # clear
    frames = 0
    last_ckpt = time.monotonic()
    recovered_frame = -1
    try:
        with RawKeyboard() as kb:
            while True:
                if app.fit_terminal:
                    # live resize: re-create outputs when the terminal changes
                    # (WM_SIZE parity, DXRExperimentsApp.cpp:257-271)
                    w, h = display.size()
                    if not use_kitty:
                        w, h = min(w, 200), min(h - h % 2, 140)
                    app.resize(w, h)
                else:
                    app.resize(*app.windowed_size)
                keys = kb.poll() if scripted is None else ([scripted.pop(0)] if scripted else ["x"])
                inp, quit_requested = app.handle_keys(keys)
                if pad is not None:
                    pad.apply(inp)
                if quit_requested:
                    break
                try:
                    img = app.step(inp)
                except Exception as e:
                    # In-session device-lost recovery (IDeviceNotify /
                    # DeviceResources::HandleDeviceLost analogue,
                    # /root/reference/src/utils/DeviceResources.cpp:447-487):
                    # rebuild the pipeline stack, restore the UI params and
                    # the last auto-checkpointed accumulation, carry on.
                    # One attempt per frame — a second failure is real.
                    if args.auto_checkpoint is None or frames == recovered_frame:
                        raise
                    print(f"viewer: render step failed ({e}); rebuilding",
                          file=sys.stderr)
                    ui_snapshot = app.ui_state()
                    app = make_app()
                    app.apply_ui_state(ui_snapshot)
                    ck = args.auto_checkpoint
                    ck = ck if ck.endswith(".npz") else ck + ".npz"
                    if os.path.exists(ck):
                        for p in app.pipelines:
                            if hasattr(p, "load_checkpoint"):
                                p.load_checkpoint(ck)
                                break
                    recovered_frame = frames
                    app.message = "recovered after device loss"
                    continue
                display.present(img, app.hud())
                frames += 1
                if args.auto_checkpoint is not None and (
                    time.monotonic() - last_ckpt >= args.checkpoint_every_sec
                ):
                    for p in app.pipelines:
                        if hasattr(p, "save_checkpoint"):
                            p.save_checkpoint(args.auto_checkpoint)
                            break
                    last_ckpt = time.monotonic()
                if args.max_frames and frames >= args.max_frames:
                    break
    finally:
        if pad is not None:
            pad.close()
        if use_alt_screen:
            sys.stdout.write("\x1b[?1049l")  # restore the main screen
        if ui_path is not None:
            try:
                app.save_ui_state(ui_path)
            except Exception as e:
                print(f"viewer: could not save UI state ({e})",
                      file=sys.stderr)
    sys.stdout.write("\n")
    print(f"viewer exited after {frames} frames; {app.stats.title()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
