"""Generalized light rig tests (VERDICT round-1 item 10).

The reference has a fixed 1-directional + 1-point rig
(/root/reference/assets/shaders/RaytracingHlslCompat.h:52-62); our rig is
stacked arrays with D, P >= 0 where the D=P=1 case reproduces the reference
lane-for-lane (pinned by the golden-image tests).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dxrexperiments_tpu.core.camera import Camera, camera_params
from dxrexperiments_tpu.scene.lights import (
    default_lights,
    dir_lights,
    directional_light,
    light_counts,
    normalize_lights,
    point_light,
    point_lights,
)
from dxrexperiments_tpu.scene.procedural import cornell_box
from dxrexperiments_tpu.scene.scene import Scene
from dxrexperiments_tpu.trace.integrator import default_options, render_sample


def _cornell_scene(lights):
    sc = Scene()
    mesh, materials = cornell_box()
    for m in materials:
        sc.add_material(m)
    sc.add_model(mesh)
    sc.lights = lights
    return sc.build(accel="none")


def _render(scene, w=48, h=48):
    cam = Camera()
    cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    cam.set_aspect(w, h)
    cp = camera_params(cam, frame_count=2, accum_count=0)
    opts = default_options(no_indirect_diffuse=True)
    return np.asarray(
        render_sample(
            scene, opts, cp, w, h, mode="progressive",
            env_kind=int(scene["env"]["kind"]),
        )["color"]
    )


def test_normalize_forms():
    single = default_lights()
    n = normalize_lights(single)
    assert n["dir"]["forward"].shape == (1, 3)
    assert n["point"]["position"].shape == (1, 3)
    assert light_counts(single) == (1, 1, 0)

    stacked = {
        "dir": dir_lights([directional_light((0, -1, 0))]),
        "point": point_lights(
            [point_light((0, 1, 0)), point_light((1, 1, 0))]
        ),
    }
    assert light_counts(stacked) == (1, 2, 0)

    as_lists = {
        "dir": [],
        "point": [point_light((0, 1, 0))],
    }
    n = normalize_lights(as_lists)
    assert n["dir"]["forward"].shape == (0, 3)
    assert n["point"]["position"].shape == (1, 3)


def test_single_rig_matches_stacked_form():
    """The classic {single dir, single point} rig must render identically to
    its stacked [1, ...] form."""
    img_single = _render(_cornell_scene(default_lights()))
    stacked = normalize_lights(default_lights())
    img_stacked = _render(_cornell_scene(stacked))
    np.testing.assert_array_equal(img_single, img_stacked)


@pytest.mark.slow
def test_lights_are_additive():
    """Direct lighting with {A, B} equals direct(A) + direct(B) minus the
    double-counted emissive/env base (linear light transport)."""
    d = directional_light((0.2, -1.0, -0.3), (0.9, 0.8, 0.7, 0.8))
    p1 = point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 4.0))
    p2 = point_light((0.5, 1.0, 0.5), (0.2, 0.4, 1.0, 3.0))

    both = _render(
        _cornell_scene({"dir": [d], "point": [p1, p2]})
    )
    only_p1 = _render(_cornell_scene({"dir": [d], "point": [p1]}))
    only_p2 = _render(_cornell_scene({"dir": [d], "point": [p2]}))
    no_p = _render(_cornell_scene({"dir": [d], "point": []}))

    lhs = both
    rhs = only_p1 + only_p2 - no_p
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4, atol=1e-5)


def test_zero_lights():
    scene = _cornell_scene({"dir": [], "point": []})
    img = _render(scene)
    assert np.isfinite(img).all()  # emissive lamp remains; no NaNs

    # the direct-lighting AOV must be exactly zero with an empty rig
    cam = Camera()
    cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    cam.set_aspect(48, 48)
    cp = camera_params(cam, frame_count=2, accum_count=0)
    opts = default_options(show_direct_lighting_only=True)
    direct = np.asarray(
        render_sample(
            scene, opts, cp, 48, 48, mode="progressive",
            env_kind=int(scene["env"]["kind"]),
        )["color"]
    )
    assert direct.max() <= 1e-6


def test_many_point_lights_render():
    rig = {
        "dir": [],
        "point": [
            point_light((np.cos(a), 1.5, np.sin(a)), (1.0, 1.0, 1.0, 1.0))
            for a in np.linspace(0, 2 * np.pi, 5, endpoint=False)
        ],
    }
    img = _render(_cornell_scene(rig))
    assert np.isfinite(img).all()
    assert img.mean() > 0.0
