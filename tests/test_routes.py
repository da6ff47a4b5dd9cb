"""The production step on the BVH route against render_sample on the
brute-force route (progressive pipeline).

A scene built with ``accel="bvh"`` traces through the lax walk
(accel/traverse.py); the same scene built with ``accel="none"`` tests every
triangle (ops/intersect.py). Both make the same hit decisions, so the
jitted production step (models/progressive.make_progressive_step) must
reproduce eager render_sample sample-for-sample across the
debug options, environment kinds and light rigs, including rigs with
several lights of one kind.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dxrexperiments_tpu.core.camera import Camera, camera_params
from dxrexperiments_tpu.models.progressive import make_progressive_step
from dxrexperiments_tpu.scene import Scene, cornell_box, envmap
from dxrexperiments_tpu.scene.lights import (
    area_light, directional_light, point_light,
)
from dxrexperiments_tpu.trace import default_options, render_sample

W = H = 24

DIR = directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6))
DIR2 = directional_light((0.5, -0.7, 0.2), (0.6, 0.7, 0.9, 0.4))
POINT = point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0))
POINT2 = point_light((-0.5, 1.2, 0.4), (0.3, 0.5, 1.0, 3.0))
AREA = area_light((-0.4, 1.96, -0.4), (0.8, 0, 0), (0, 0, 0.8),
                  (1.0, 0.9, 0.7, 4.0))
RIGS = {
    "reference": {"dir": DIR, "point": POINT},
    "area": {"dir": [DIR], "point": [], "area": [AREA]},
    "two_dir": {"dir": [DIR, DIR2], "point": []},
    "two_point": {"dir": [], "point": [POINT, POINT2]},
    "mixed": {"dir": [DIR, DIR2], "point": [POINT, POINT2], "area": [AREA]},
    "none": {"dir": [], "point": []},
}


def _env(kind):
    rs = np.random.default_rng(3)
    if kind == "const":
        return envmap.constant_env((0.05, 0.1, 0.2), strength=1.5)
    if kind == "gradient":
        return envmap.gradient_env()
    if kind == "latlong":
        return envmap.latlong_env(
            rs.uniform(0, 2, (8, 16, 3)).astype(np.float32), strength=1.3)
    return envmap.cubemap_env(
        rs.uniform(0, 2, (6, 8, 8, 3)).astype(np.float32), strength=1.3)


def scenes(rig="reference", env="const", textured=False, glass=False):
    """(BVH-route scene, brute-route scene) of one Cornell box."""
    mesh, materials = cornell_box(glossy_tall_box=True,
                                  textured_floor=textured)
    sc = Scene()
    for m in materials:
        sc.add_material(m)
    sc.add_model(mesh)
    if glass:
        from dxrexperiments_tpu.app.headless import build_scene

        sc, _ = build_scene("cornell-glass")
    sc.lights = RIGS[rig]
    sc.environment = _env(env)
    return sc.build(accel="bvh"), sc.build(accel="none")


def camera(frame=7, jitter=(0.3 / W, -0.2 / H), w=W, h=H, accum_count=0):
    cam = Camera()
    cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    cam.set_aspect(w, h)
    return camera_params(cam, jitter=jitter, frame_count=frame,
                         accum_count=accum_count)


def production(scene, options, cam, w=W, h=H, accum=None, max_iter=64, **kw):
    """One accumulation step of the production step factory."""
    assert "bvh" in scene
    step = make_progressive_step(scene, w, h, **kw)
    if accum is None:
        accum = jnp.zeros((h, w, 3), jnp.float32)
    return step(accum, options, cam, scene["lights"], scene["env"],
                jnp.asarray(max_iter, jnp.int32))


def oracle(scene, options, cam, w=W, h=H, **kw):
    assert "bvh" not in scene
    return render_sample(scene, options, cam, w, h, mode="progressive",
                         env_kind=int(scene["env"]["kind"]), **kw)["color"]


def assert_images_match(got, want, frac=0.005, tol=1e-3):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    bad = (diff > tol).any(axis=-1).mean()
    assert bad <= frac, f"{bad:.4%} pixels differ by more than {tol}"
    assert float(np.median(diff)) < 1e-5


OPTION_CASES = [
    {},
    {"debug": 2},
    {"no_indirect_diffuse": True},
    {"cosine_hemisphere_sampling": False},
    {"show_direct_lighting_only": True},
    {"show_gbuffer_albedo_only": True},
    {"show_fresnel_term": True},
    {"show_indirect_specular_only": True},
    {"show_indirect_diffuse_only": True},
    {"debug": 2, "no_indirect_diffuse": True},
]


@pytest.mark.parametrize("opts", OPTION_CASES)
def test_route_matches_oracle_options(opts):
    bvh, brute = scenes()
    options = default_options(**opts)
    cam = camera()
    assert_images_match(production(bvh, options, cam),
                        oracle(brute, options, cam))


@pytest.mark.parametrize("env", ["const", "gradient", "latlong", "cubemap"])
def test_route_env_kinds(env):
    bvh, brute = scenes(env=env)
    cam = camera(frame=5, jitter=(0.002, -0.001))
    assert_images_match(production(bvh, default_options(), cam),
                        oracle(brute, default_options(), cam))


@pytest.mark.parametrize("rig", ["area", "two_dir", "two_point", "mixed",
                                 "none"])
def test_route_light_rigs(rig):
    """Rigs with several lights of a kind (which no single-light shading
    path could take) shade identically on both routes."""
    bvh, brute = scenes(rig=rig, env="gradient")
    cam = camera(frame=3)
    assert_images_match(production(bvh, default_options(), cam),
                        oracle(brute, default_options(), cam))


@pytest.mark.parametrize("opts", [{"debug": 2}, {"no_indirect_diffuse": True},
                                  {"show_direct_lighting_only": True}])
def test_route_area_rig_options(opts):
    bvh, brute = scenes(rig="area", env="gradient")
    options = default_options(**opts)
    cam = camera(frame=9)
    assert_images_match(production(bvh, options, cam),
                        oracle(brute, options, cam))


def test_route_mixed_rig_light_pick():
    """debug == 2 picks one of L = 5 lights per shading point."""
    bvh, brute = scenes(rig="mixed", env="gradient")
    options = default_options(debug=2)
    cam = camera(frame=11)
    assert_images_match(production(bvh, options, cam),
                        oracle(brute, options, cam))


@pytest.mark.parametrize("opts", [{}, {"show_gbuffer_albedo_only": True},
                                  {"show_indirect_specular_only": True}])
def test_route_textured_albedo(opts):
    bvh, brute = scenes(rig="area", env="cubemap", textured=True)
    assert "textures" in bvh
    options = default_options(**opts)
    cam = camera(frame=5, jitter=(0.002, -0.001))
    assert_images_match(production(bvh, options, cam),
                        oracle(brute, options, cam))


@pytest.mark.parametrize("samples", [2, 4])
def test_route_multi_sample_mean(samples):
    """S samples in one dispatch == the mean of S single-sample renders."""
    bvh, brute = scenes()
    cams = [camera(frame=f, jitter=((0.13 + 0.1 * f) / W,
                                    (-0.07 - 0.05 * f) / H))
            for f in range(samples)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
    got = production(bvh, default_options(), stacked,
                     samples_per_step=samples)
    want = sum(np.asarray(oracle(brute, default_options(), c))
               for c in cams) / samples
    assert_images_match(got, want, tol=2e-3)


def test_route_folds_into_accumulation():
    """accum_count = n folds the new sample in as (n * prev + cur)/(n + 1)."""
    bvh, brute = scenes()
    prev = jnp.full((H, W, 3), 0.25, jnp.float32)
    cam = camera(frame=4, accum_count=3)
    got = production(bvh, default_options(), cam, accum=prev)
    want = (3.0 * 0.25 + np.asarray(oracle(brute, default_options(), cam))) / 4
    assert_images_match(got, want)


def test_route_converged_keeps_accumulation():
    bvh, _ = scenes()
    prev = jnp.full((H, W, 3), 0.5, jnp.float32)
    got = production(bvh, default_options(), camera(accum_count=8),
                     accum=prev, max_iter=8)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(prev))


def test_route_soup_deep_tree():
    """A 3,000-triangle soup: a multi-level tree, partial leaves and
    incoherent bounce rays."""
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
    assert_images_match(production(sc.build(accel="bvh"), default_options(), cam),
                        oracle(sc.build(accel="none"), default_options(), cam))


def test_route_non_square_raster():
    w, h = 40, 24
    bvh, brute = scenes()
    cam = camera(frame=4, w=w, h=h)
    assert_images_match(production(bvh, default_options(), cam, w=w, h=h),
                        oracle(brute, default_options(), cam, w=w, h=h))


def test_route_ambient_occlusion_view():
    bvh, brute = scenes()
    cam = camera(frame=6)
    assert_images_match(
        production(bvh, default_options(), cam, ao_only=True),
        oracle(brute, default_options(), cam, ao_only=True))


def test_route_refraction():
    bvh, brute = scenes(glass=True)
    cam = camera(frame=2)
    assert_images_match(
        production(bvh, default_options(), cam, refraction=True),
        oracle(brute, default_options(), cam, refraction=True))
