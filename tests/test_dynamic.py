"""Device-side instance re-baking vs host Scene.build."""

import jax.numpy as jnp
import numpy as np

from dxrexperiments_tpu.scene import Scene, envmap
from dxrexperiments_tpu.scene.dynamic import bake_instances, prepare_base
from dxrexperiments_tpu.scene.lights import default_lights
from dxrexperiments_tpu.scene.materials import Material
from dxrexperiments_tpu.scene.mesh import fallback_triangle
from dxrexperiments_tpu.scene.procedural import box_mesh


def transforms_grid(n, spacing=3.0, yaw0=0.0):
    ts = []
    for i in range(n):
        c, s = np.cos(yaw0 + i), np.sin(yaw0 + i)
        t = np.eye(4, dtype=np.float32)
        t[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        t[0, 3] = i * spacing
        ts.append(t)
    return np.stack(ts)


def host_build(mesh, transforms, mats):
    sc = Scene()
    for m in mats:
        sc.add_material(m)
    for t in np.asarray(transforms):
        sc.add_model(mesh, transform=t, material=0)
    return sc.build(accel="none")


def test_bake_matches_host_build():
    mesh = box_mesh((0, 0.5, 0), (1, 1, 1), 0)
    mats = [Material(albedo=(0.9, 0.3, 0.2, 1))]
    tfs = transforms_grid(4)

    host = host_build(mesh, tfs, mats)

    base_scene = host_build(mesh, np.eye(4)[None], mats)
    base = prepare_base(
        {**base_scene, "num_tris": base_scene["num_tris"]}, 4
    )
    dev = bake_instances(base, jnp.asarray(tfs))

    nb = base_scene["v0"].shape[0]  # base mesh triangles (a box: 12)
    n_host = int(host["num_tris"])
    # Compare per-instance blocks: both layouts are [I * nb] in instance
    # order.
    dv0 = np.asarray(dev["v0"]).reshape(4, nb, 3)[:, :12].reshape(-1, 3)
    np.testing.assert_allclose(dv0, np.asarray(host["v0"][:n_host]), atol=1e-4)
    dn0 = np.asarray(dev["n0"]).reshape(4, nb, 3)[:, :12].reshape(-1, 3)
    np.testing.assert_allclose(dn0, np.asarray(host["n0"][:n_host]), atol=1e-4)
    dpn = np.asarray(dev["pn"]).reshape(4, nb, 3)[:, :12].reshape(-1, 3)
    np.testing.assert_allclose(dpn, np.asarray(host["pn"][:n_host]), atol=1e-3)


def test_baked_scene_renders_and_animates():
    from dxrexperiments_tpu.core.camera import Camera, camera_params
    from dxrexperiments_tpu.trace.integrator import default_options, render_sample

    mesh = fallback_triangle()
    mats = [Material(albedo=(0.9, 0.1, 0.1, 1))]
    base_scene = host_build(mesh, np.eye(4)[None], mats)
    base = prepare_base(base_scene, 8)  # 8 instances of the triangle

    cam = Camera()
    cam.set_eye_at_up((10.0, 1.0, 14.0), (10.0, 0.0, 0.0), (0, 1, 0))
    cam.set_aspect(1, 1)
    options = default_options()
    lights = default_lights()
    env = envmap.constant_env((0.1, 0.2, 0.3))

    imgs = []
    for yaw in (0.0, 0.9):
        tfs = jnp.asarray(transforms_grid(8, yaw0=yaw))
        scene = bake_instances(base, tfs, lights=lights, env=env)
        out = render_sample(
            scene, options, camera_params(cam), 48, 48)
        imgs.append(np.asarray(out["color"]))
    assert all(np.isfinite(i).all() for i in imgs)
    assert imgs[0].max() > 0.01  # instances visible
    assert not np.allclose(imgs[0], imgs[1])  # rotation changed the frame
