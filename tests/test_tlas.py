"""Two-level TLAS/BLAS tests: the lax walk vs the jnp oracle vs the
flattened build, refit correctness, and no-recompile dynamic animation.

Covers VERDICT round-1 item 4: true two-level traversal with per-instance
transforms (reference: /root/reference/Helpers/TopLevelASGenerator.cpp:64-83,
/root/reference/libs/DXRFramework/RtScene.cpp:27-51).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dxrexperiments_tpu.accel import tlas as tlas_mod
from dxrexperiments_tpu.accel import traverse
from dxrexperiments_tpu.scene.mesh import Mesh
from dxrexperiments_tpu.scene.materials import Material
from dxrexperiments_tpu.scene.procedural import box_mesh, sphere_mesh
from dxrexperiments_tpu.scene.scene import Scene
from dxrexperiments_tpu.scene.dynamic import refit_scene_instances


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def _tf(translate=(0, 0, 0), yaw=0.0, scale=1.0):
    m = _rot_y(yaw)
    m[:3, :3] *= scale
    m[:3, 3] = translate
    return m


def _two_mesh_scene(transforms=None):
    """2 unique meshes, 5 instances with rotation/translation/scale and a
    material override on some."""
    sc = Scene()
    white = sc.add_material(Material(albedo=(0.73, 0.73, 0.73, 1.0)))
    red = sc.add_material(Material(albedo=(0.9, 0.1, 0.1, 1.0)))
    box = box_mesh((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    sph = sphere_mesh((0.0, 0.0, 0.0), 0.6, lat=6, lon=8)
    tfs = transforms or [
        _tf((0, 0, 0)),
        _tf((2.5, 0.2, 0), yaw=0.7),
        _tf((-2.5, 0, 0.5), yaw=-0.4, scale=1.4),
        _tf((0, 0, 2.5), scale=0.8),
        _tf((0, 1.5, -2.5), yaw=2.0),
    ]
    sc.add_model(box, transform=tfs[0], material=white)
    sc.add_model(box, transform=tfs[1], material=red)
    sc.add_model(sph, transform=tfs[2], material=white)
    sc.add_model(sph, transform=tfs[3], material=red)
    sc.add_model(box, transform=tfs[4], material=white)
    return sc


def _probe_rays(n=512, seed=0):
    rng = np.random.default_rng(seed)
    # Rays from a shell, aimed at jittered points near the origin cluster.
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 8.0
    target = rng.normal(scale=1.8, size=(n, 3)).astype(np.float32)
    d = target - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.fixture(scope="module")
def two_level_scene():
    return _two_mesh_scene().build_two_level()


@pytest.fixture(scope="module")
def flat_scene():
    return _two_mesh_scene().build(accel="none")


def test_kernel_matches_oracle_closest(two_level_scene):
    o, d = _probe_rays()
    ker = traverse.two_level_closest(
        two_level_scene["tlas"], o, d, 1e-4, 3.0e37
    )
    ora = tlas_mod.two_level_closest_jnp(two_level_scene, o, d, 1e-4, 3.0e37,
                                         cull=False)
    np.testing.assert_array_equal(np.asarray(ker["hit"]), np.asarray(ora["hit"]))
    h = np.asarray(ker["hit"])
    np.testing.assert_allclose(
        np.asarray(ker["t"])[h], np.asarray(ora["t"])[h], rtol=2e-4, atol=2e-4
    )
    np.testing.assert_array_equal(
        np.asarray(ker["tri"])[h], np.asarray(ora["tri"])[h]
    )
    np.testing.assert_array_equal(
        np.asarray(ker["inst"])[h], np.asarray(ora["inst"])[h]
    )
    np.testing.assert_allclose(
        np.asarray(ker["u"])[h], np.asarray(ora["u"])[h], rtol=2e-3, atol=2e-4
    )


def test_kernel_matches_oracle_any(two_level_scene):
    o, d = _probe_rays(seed=1)
    ker = traverse.two_level_any(two_level_scene["tlas"], o, d, 1e-4, 3.0e37)
    ora = tlas_mod.two_level_any_jnp(two_level_scene, o, d, 1e-4, 3.0e37)
    np.testing.assert_array_equal(np.asarray(ker), np.asarray(ora))


def test_two_level_agrees_with_flattened(two_level_scene, flat_scene):
    """Hit-for-hit agreement with the flattened world-space build (the
    VERDICT item-4 acceptance test)."""
    from dxrexperiments_tpu.ops import intersect

    o, d = _probe_rays(seed=2)
    two = tlas_mod.two_level_closest_jnp(
        two_level_scene, o, d, 1e-4, 3.0e37, cull=False
    )
    flat = intersect.intersect_closest(flat_scene, o, d, 1e-4, 3.0e37)
    np.testing.assert_array_equal(np.asarray(two["hit"]), np.asarray(flat["hit"]))
    h = np.asarray(two["hit"])
    np.testing.assert_allclose(
        np.asarray(two["t"])[h], np.asarray(flat["t"])[h], rtol=2e-4, atol=2e-4
    )


@pytest.mark.slow
def test_render_two_level_matches_flattened():
    """Full render (1 progressive sample, fixed RNG) through the two-level
    walk vs the flattened brute-force path."""
    from dxrexperiments_tpu.core.camera import Camera, camera_params
    from dxrexperiments_tpu.trace.integrator import default_options, render_sample

    sc = _two_mesh_scene()
    cam = Camera()
    cam.set_eye_at_up((6.0, 4.0, 6.0), (0.0, 0.3, 0.0), (0.0, 1.0, 0.0))
    cam.set_aspect(64, 64)
    cam_params = camera_params(cam, frame_count=3, accum_count=0)
    opts = default_options()

    s2 = sc.build_two_level()
    img2 = render_sample(
        s2, opts, cam_params, 64, 64, mode="progressive",
        env_kind=int(s2["env"]["kind"]),
    )["color"]
    sf = sc.build(accel="none")
    imgf = render_sample(
        sf, opts, cam_params, 64, 64, mode="progressive",
        env_kind=int(sf["env"]["kind"]),
    )["color"]
    np.testing.assert_allclose(
        np.asarray(img2), np.asarray(imgf), rtol=5e-3, atol=5e-3
    )


def test_refit_matches_fresh_build():
    """Refit to new transforms == fresh two-level build of the moved scene
    (same Morton order fixture so instance slots align)."""
    sc = _two_mesh_scene()
    s0 = sc.build_two_level()
    ctx = s0["tlas_meta"].value["refit_ctx"]

    moved = [
        _tf((0.3, 0.1, -0.2), yaw=0.3),
        _tf((2.0, 0.4, 0.3), yaw=1.1),
        _tf((-2.8, 0.2, 0.7), yaw=-0.9, scale=1.2),
        _tf((0.4, 0, 2.9), scale=0.9),
        _tf((-0.3, 1.8, -2.2), yaw=2.4),
    ]
    tf_arr = jnp.asarray(np.stack(moved))
    s_refit = refit_scene_instances(s0, tf_arr)

    o, d = _probe_rays(seed=3)
    ker = traverse.two_level_closest(s_refit["tlas"], o, d, 1e-4, 3.0e37)
    ora = tlas_mod.two_level_closest_jnp(s_refit, o, d, 1e-4, 3.0e37, cull=False)
    np.testing.assert_array_equal(np.asarray(ker["hit"]), np.asarray(ora["hit"]))
    h = np.asarray(ker["hit"])
    np.testing.assert_allclose(
        np.asarray(ker["t"])[h], np.asarray(ora["t"])[h], rtol=2e-4, atol=2e-4
    )

    # And against a flattened build of the moved scene.
    from dxrexperiments_tpu.ops import intersect

    flat = _two_mesh_scene(transforms=moved).build(accel="none")
    fl = intersect.intersect_closest(flat, o, d, 1e-4, 3.0e37)
    np.testing.assert_array_equal(np.asarray(ker["hit"]), np.asarray(fl["hit"]))
    np.testing.assert_allclose(
        np.asarray(ker["t"])[h], np.asarray(fl["t"])[h], rtol=2e-4, atol=2e-4
    )


def test_dynamic_pipeline_no_recompile():
    """set_instance_transforms must reuse the compiled step (refit is a pure
    argument change, the whole point of the two-level design)."""
    from dxrexperiments_tpu.core.camera import Camera
    from dxrexperiments_tpu.models.progressive import ProgressiveRaytracingPipeline

    sc = _two_mesh_scene()
    pipe = ProgressiveRaytracingPipeline(width=32, height=32, seed=0)
    cam = Camera()
    cam.set_eye_at_up((6.0, 4.0, 6.0), (0.0, 0.3, 0.0), (0.0, 1.0, 0.0))
    pipe.set_camera(cam)
    pipe.set_scene_data(sc.build_two_level())

    tfs = np.stack([np.eye(4, dtype=np.float32)] * 5)
    tfs[:, 0, 3] = np.arange(5) * 2.0
    pipe.set_instance_transforms(jnp.asarray(tfs))
    pipe.update(0.0, 0)
    pipe.render()
    step0 = pipe._step

    tfs[:, 2, 3] = 1.0
    pipe.set_instance_transforms(jnp.asarray(tfs))
    pipe.update(0.0, 1)
    img = pipe.render()
    assert pipe._step is step0, "TLAS refit must not rebuild the step"
    assert np.isfinite(np.asarray(img)).all()
    assert pipe.accum_count == 1  # dirty flag restarted accumulation


@pytest.mark.parametrize("cull", [False, True])
def test_walk_matches_flattened_walk_closest(two_level_scene, cull):
    """The two-level walk vs the single-level walk over the flattened build
    of the same instances: same hits, same t, same instance and
    instance-local triangle."""
    flat = _two_mesh_scene().build(accel="bvh")
    o, d = _probe_rays(seed=5)
    a = traverse.two_level_closest(
        two_level_scene["tlas"], o, d, 1e-4, 3.0e37, cull_backface=cull
    )
    b = traverse.closest(flat["bvh"], o, d, 1e-4, 3.0e37, cull_backface=cull)
    h = np.asarray(b["hit"])
    np.testing.assert_array_equal(np.asarray(a["hit"]), h)
    np.testing.assert_allclose(
        np.asarray(a["t"])[h], np.asarray(b["t"])[h], rtol=2e-4, atol=2e-4
    )
    orig = np.asarray(two_level_scene["tlas"]["inst_orig"])[np.asarray(a["inst"])]
    np.testing.assert_array_equal(
        orig[h], np.asarray(flat["inst_id"])[np.asarray(b["tri"])][h]
    )


def test_walk_matches_flattened_walk_any(two_level_scene):
    flat = _two_mesh_scene().build(accel="bvh")
    o, d = _probe_rays(seed=6)
    a = traverse.two_level_any(two_level_scene["tlas"], o, d, 1e-4, 6.0)
    b = traverse.any_hit(flat["bvh"], o, d, 1e-4, 6.0)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_refit_tlas_matches_fresh_build():
    """Refit with new transforms must regenerate the TLAS boxes and the
    instance transforms identically to a from-scratch build at those
    transforms (the topology rows are frozen)."""
    sc = _two_mesh_scene()
    built = sc.build_two_level()
    ctx = built["tlas_meta"].value["refit_ctx"]
    transforms = np.stack([i.transform for i in sc.instances])
    transforms[:, 0, 3] += 0.75  # translate all instances in x
    dyn = tlas_mod.refit_instances_arrays(ctx, jnp.asarray(transforms))

    sc2 = _two_mesh_scene()
    for inst, t in zip(sc2.instances, transforms):
        inst.transform = t.astype(np.float32)
    fresh = sc2.build_two_level()["tlas"]
    for k in ("tlas_nodes", "xf"):
        np.testing.assert_allclose(
            np.asarray(dyn[k]), np.asarray(fresh[k]), atol=1e-5, err_msg=k
        )
    np.testing.assert_array_equal(
        np.asarray(built["tlas"]["child"]), np.asarray(fresh["child"])
    )


@pytest.mark.parametrize("n_inst", [1, 3, 9])
def test_walk_instance_counts(n_inst):
    """Single-instance TLAS (a root with one empty child), and instance
    counts that leave padding slots in the TLAS heap."""
    sc = Scene()
    sph = sphere_mesh((0.0, 0.0, 0.0), 0.6, lat=6, lon=8)
    for i in range(n_inst):
        sc.add_model(sph, transform=_tf((1.5 * i - 1.5, 0.1 * i, 0.0)))
    scene = sc.build_two_level()
    o, d = _probe_rays(seed=8)
    got = traverse.two_level_closest(scene["tlas"], o, d, 1e-4, 3.0e37)
    ora = tlas_mod.two_level_closest_jnp(scene, o, d, 1e-4, 3.0e37, cull=False)
    h = np.asarray(ora["hit"])
    assert h.any()
    np.testing.assert_array_equal(np.asarray(got["hit"]), h)
    np.testing.assert_array_equal(
        np.asarray(got["inst"])[h], np.asarray(ora["inst"])[h]
    )
