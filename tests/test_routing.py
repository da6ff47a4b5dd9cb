"""One route per job: which intersector each scene kind reaches, where a
scene gets a BVH, and that geometry is an argument of the compiled step."""

import jax.numpy as jnp
import numpy as np
import pytest

from dxrexperiments_tpu.accel import traverse
from dxrexperiments_tpu.app.headless import build_scene
from dxrexperiments_tpu.core.camera import camera_params
from dxrexperiments_tpu.ops import intersect
from dxrexperiments_tpu.scene import Scene, scene as scene_mod
from dxrexperiments_tpu.scene.procedural import random_triangle_soup
from dxrexperiments_tpu.trace import integrator
from dxrexperiments_tpu.trace.integrator import default_options

ROUTES = {
    "brute": (intersect, "intersect_closest", "intersect_any"),
    "bvh": (traverse, "closest", "any_hit"),
    "two_level": (traverse, "two_level_closest", "two_level_any"),
}


def _scene(kind):
    sc, _ = build_scene("instanced:1")
    if kind == "two_level":
        return sc.build_two_level()
    return sc.build(accel="bvh" if kind == "bvh" else "none")


def _calls(monkeypatch):
    """Wrap every route's entry points to record which ones run."""
    seen = []
    for mod, *names in ROUTES.values():
        for name in names:
            fn = getattr(mod, name)

            def wrapped(*a, _fn=fn, _name=name, **kw):
                seen.append(_name)
                return _fn(*a, **kw)

            monkeypatch.setattr(mod, name, wrapped)
    return seen


def _rays(n=64, seed=0):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    o[:, 1] = 3.0
    d = np.tile(np.float32([[0.0, -1.0, 0.0]]), (n, 1))
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("kind", sorted(ROUTES))
def test_closest_trace_route(kind, monkeypatch):
    scene = _scene(kind)
    seen = _calls(monkeypatch)
    o, d = _rays()
    hit, _, _, _ = integrator._trace_closest(scene, o, d, 1e-4, 1e30, False)
    assert seen == [ROUTES[kind][1]]
    assert np.asarray(hit).any()


@pytest.mark.parametrize("kind", sorted(ROUTES))
def test_any_trace_route(kind, monkeypatch):
    scene = _scene(kind)
    seen = _calls(monkeypatch)
    o, d = _rays()
    occ = integrator._trace_any(scene, o, d, 1e-4, 1e30)
    assert seen == [ROUTES[kind][2]]
    assert np.asarray(occ).any()


@pytest.mark.parametrize("extra", [0, 1])
def test_bvh_threshold(extra):
    """A BVH is attached above BVH_THRESHOLD triangles, not at it."""
    sc = Scene()
    sc.add_model(random_triangle_soup(scene_mod.BVH_THRESHOLD + extra, seed=1))
    assert ("bvh" in sc.build()) == bool(extra)


@pytest.mark.parametrize("mode", ["progressive", "realtime"])
def test_geometry_is_a_step_argument(mode):
    """A step compiled for one scene renders another scene of the same
    structure, passed as geo_arg, exactly as that scene's own step does:
    geometry is never baked into the compiled step."""
    sc, cam = build_scene("cornell-glossy")
    cam.set_aspect(16, 16)
    scene_a = sc.build()
    for inst in sc.instances:  # the same box, moved
        inst.transform = inst.transform.copy()
        inst.transform[0, 3] += 0.3
    scene_b = sc.build()
    cp = camera_params(cam, jitter=(0.01, -0.02), frame_count=3)
    args = (default_options(), cp, scene_b["lights"], scene_b["env"])
    step_a = integrator.make_render_step(scene_a, 16, 16, mode=mode)
    step_b = integrator.make_render_step(scene_b, 16, 16, mode=mode)
    got = step_a(*args, geo_arg=integrator.scene_geometry(scene_b))
    want = step_b(*args)
    moved = step_a(*args)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   atol=1e-6)
    assert not np.allclose(np.asarray(moved["color"]),
                           np.asarray(want["color"]))
