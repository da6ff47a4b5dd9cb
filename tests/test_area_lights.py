"""Area-light soft shadows (BASELINE config 2's "area-light soft shadows").

BEYOND-reference capability: the DXR reference's rig is one fixed
directional + one point light
(/root/reference/assets/shaders/RaytracingHlslCompat.h:52-62) — quad area
lights with N-sample stratified soft shadows extend it. All area shadow
rays join the same single batched any-hit launch as the other lights'
rays (trace.integrator._direct_lighting).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dxrexperiments_tpu.core.camera import Camera, camera_params
from dxrexperiments_tpu.scene.lights import (
    area_light,
    area_lights,
    light_counts,
    normalize_lights,
    point_light,
)
from dxrexperiments_tpu.scene.materials import Material
from dxrexperiments_tpu.scene.mesh import Mesh, compute_smooth_normals
from dxrexperiments_tpu.scene.procedural import box_mesh, merge_meshes, quad
from dxrexperiments_tpu.scene.scene import Scene
from dxrexperiments_tpu.trace.integrator import default_options, render_sample


def _floor_scene(rig, blocker=False):
    """4x4 floor quad at y=0; optional thin blocker slab at y=1."""
    pos, idx = quad([-2, 0, -2], [-2, 0, 2], [2, 0, 2], [2, 0, -2])
    meshes = [Mesh(pos, compute_smooth_normals(pos, idx), idx, name="floor")]
    if blocker:
        meshes.append(box_mesh((0.0, 1.0, 0.0), (0.5, 0.05, 0.5), 0))
    sc = Scene()
    sc.add_material(Material(albedo=(0.8, 0.8, 0.8, 1.0)))
    sc.add_model(merge_meshes(meshes))
    sc.lights = rig
    return sc.build(accel="none")


def _render_direct(scene, w=64, h=64):
    cam = Camera()
    cam.set_eye_at_up((0, 2.5, 2.5), (0, 0, 0), (0, 1, 0))
    cam.set_aspect(w, h)
    cp = camera_params(cam, frame_count=2, accum_count=0)
    opts = default_options(show_direct_lighting_only=True)
    return np.asarray(
        render_sample(
            scene, opts, cp, w, h, mode="progressive",
            env_kind=int(scene["env"]["kind"]),
        )["color"]
    ).mean(-1)


def test_area_forms():
    a = area_light((-0.5, 2, -0.5), (1, 0, 0), (0, 0, 1), (1, 1, 1, 4.0))
    n = normalize_lights({"area": [a, a]})
    assert n["area"]["corner"].shape == (2, 3)
    assert n["area"]["eu"].shape == (2, 3)
    assert n["dir"]["forward"].shape == (0, 3)
    assert light_counts({"area": [a, a]}) == (0, 0, 2)
    assert light_counts({"area": a}) == (0, 0, 1)  # single-dict form
    stacked = area_lights([a])
    assert light_counts({"area": stacked}) == (0, 0, 1)


def test_area_soft_shadow_is_fractional():
    """Visibility ratio occluded/unoccluded: binary {0,1} for a point
    light, fractional (penumbra) for an area light — the defining
    property of soft shadows."""
    arig = {"area": [area_light((-0.5, 2, -0.5), (1, 0, 0), (0, 0, 1),
                                (1, 1, 1, 4.0))]}
    prig = {"point": [point_light((0.0, 2.0, 0.0), (1, 1, 1, 4.0))]}

    def frac_vis(rig):
        occ = _render_direct(_floor_scene(rig, blocker=True))
        uno = _render_direct(_floor_scene(rig, blocker=False))
        ratio = np.where(uno > 1e-5, occ / np.maximum(uno, 1e-9), 1.0)
        return ((ratio > 0.1) & (ratio < 0.9)).mean()

    assert frac_vis(arig) > 0.05      # wide penumbra band
    assert frac_vis(prig) < 0.005     # hard shadow: no partial pixels


def test_tiny_area_light_matches_point_light_on_axis():
    """A quad much smaller than its distance converges to a point source.
    With the estimator's Lambertian-emitter cosine == 1 on axis, a quad of
    radiance L_a and area A equals a point light of intensity 2*pi*L_a*A
    (the point falloff is I/(2*pi*d^2), RaytracingCommon.hlsli:126-147).
    Validates the absolute scale of the area estimator against the
    reference-parity point path."""
    s, lp = 0.1, 4.0
    la = lp / (2.0 * np.pi) / (s * s)
    tiny = {"area": [area_light((-s / 2, 2.0, -s / 2), (s, 0, 0), (0, 0, s),
                                (1, 1, 1, la))]}
    prig = {"point": [point_light((0.0, 2.0, 0.0), (1, 1, 1, lp))]}
    ia = _render_direct(_floor_scene(tiny))
    ip = _render_direct(_floor_scene(prig))
    # center window = floor directly under the light (cos theta ~= 1)
    ca, cp_ = ia[30:34, 30:34], ip[30:34, 30:34]
    np.testing.assert_allclose(ca, cp_, rtol=0.02)


def test_area_light_linearity_and_mix():
    """Doubling intensity doubles the direct term, and an area light
    composes with the classic rig in one render."""
    mk = lambda i: {"area": [area_light((-0.5, 2, -0.5), (1, 0, 0),
                                        (0, 0, 1), (1, 1, 1, i))]}
    i1 = _render_direct(_floor_scene(mk(2.0)))
    i2 = _render_direct(_floor_scene(mk(4.0)))
    np.testing.assert_allclose(i2, 2.0 * i1, rtol=1e-5, atol=1e-6)

    mixed = {
        "dir": [],
        "point": [point_light((0.5, 2.0, 0.5), (1, 1, 1, 2.0))],
        "area": [area_light((-0.5, 2, -0.5), (1, 0, 0), (0, 0, 1),
                            (1, 1, 1, 2.0))],
    }
    img = _render_direct(_floor_scene(mixed, blocker=True))
    assert np.isfinite(img).all() and img.max() > 0
