"""The realtime production step on the BVH route against render_sample on
the brute-force route: every AOV the denoiser reads, across environment
kinds, light rigs, textured albedo and a deep tree (see test_routes.py for
the progressive pipeline)."""

import numpy as np
import pytest

from dxrexperiments_tpu.scene import Scene, envmap
from dxrexperiments_tpu.scene.lights import directional_light, point_light
from dxrexperiments_tpu.trace import default_options, render_sample
from dxrexperiments_tpu.trace.integrator import make_render_step
from tests.test_routes import H, W, camera, scenes

AOV_KEYS = ("color", "direct", "indirect_specular", "albedo", "roughness")


def production(scene, options, cam):
    assert "bvh" in scene
    step = make_render_step(scene, W, H, mode="realtime", jitter_scale=10.0)
    return step(options, cam, scene["lights"], scene["env"])


def oracle(scene, options, cam):
    assert "bvh" not in scene
    return render_sample(scene, options, cam, W, H, mode="realtime",
                         jitter_scale=10.0,
                         env_kind=int(scene["env"]["kind"]))


def assert_aovs_match(got, want, frac=0.005):
    assert set(got) >= set(AOV_KEYS)
    for k in AOV_KEYS:
        g = np.asarray(got[k])
        w = np.asarray(want[k])
        assert g.shape == w.shape and np.isfinite(g).all(), k
        diff = np.abs(g - w).reshape(H * W, -1)
        assert (diff.max(axis=-1) > 1e-3).mean() <= frac, k
        assert float(np.median(diff)) < 1e-5, k


@pytest.mark.parametrize("env", ["const", "gradient", "latlong", "cubemap"])
def test_realtime_route_env_kinds(env):
    """Misses route the environment into the direct AOV on both routes."""
    bvh, brute = scenes(env=env)
    cam = camera(frame=5, jitter=(0.003, -0.002))
    assert_aovs_match(production(bvh, default_options(), cam),
                      oracle(brute, default_options(), cam))


@pytest.mark.parametrize("rig", ["area", "two_point", "mixed"])
def test_realtime_route_light_rigs(rig):
    bvh, brute = scenes(rig=rig, env="gradient")
    cam = camera(frame=5, jitter=(0.003, -0.002))
    assert_aovs_match(production(bvh, default_options(), cam),
                      oracle(brute, default_options(), cam))


def test_realtime_route_light_pick():
    bvh, brute = scenes(rig="mixed", env="gradient")
    options = default_options(debug=2)
    cam = camera(frame=8)
    assert_aovs_match(production(bvh, options, cam),
                      oracle(brute, options, cam))


def test_realtime_route_textured_albedo():
    bvh, brute = scenes(rig="area", env="cubemap", textured=True)
    cam = camera(frame=5, jitter=(0.002, -0.001))
    assert_aovs_match(production(bvh, default_options(), cam),
                      oracle(brute, default_options(), cam))


def test_realtime_route_soup_deep_tree():
    from dxrexperiments_tpu.scene.materials import Material
    from dxrexperiments_tpu.scene.procedural import random_triangle_soup

    sc = Scene()
    sc.add_material(Material.reference_default())
    sc.add_model(random_triangle_soup(3000, seed=11, extent=3.0))
    sc.lights = {"dir": directional_light((0.2, -0.8, -0.5),
                                          (1.0, 1.0, 0.9, 0.8)),
                 "point": point_light((0.5, 2.0, 0.5), (1.0, 0.9, 0.7, 5.0))}
    sc.environment = envmap.gradient_env()
    cam = camera(frame=5)
    assert_aovs_match(production(sc.build(accel="bvh"), default_options(), cam),
                      oracle(sc.build(accel="none"), default_options(), cam))
