"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import os
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from dxrexperiments_tpu.parallel import (
    make_render_mesh,
    make_sharded_progressive_step,
    make_sharded_realtime_step,
    progressive_step_sharded,
    render_samples_sharded,
    replicate_scene,
    stack_cameras,
)


def needs_devices(n):
    return pytest.mark.skipif(
        jax.device_count() < n, reason=f"needs {n} virtual devices"
    )


def setup(width, height, n_samples):
    from __graft_entry__ import _cornell_setup

    return _cornell_setup(width, height, n_samples)


@needs_devices(8)
def test_mesh_shapes():
    mesh = make_render_mesh(n_tile=4, n_spp=2)
    assert mesh.shape == {"tile": 4, "spp": 2}
    mesh2 = make_render_mesh()
    assert mesh2.shape["tile"] == jax.device_count()


@needs_devices(8)
def test_sharded_matches_single_chip_mean():
    """The sharded S-sample mean must equal the unsharded computation."""
    width, height = 32, 32
    scene, options, cams, _ = setup(width, height, 4)
    cameras = stack_cameras(cams)

    mesh = make_render_mesh(n_tile=2, n_spp=4)
    scene_r = replicate_scene(scene, mesh)
    sharded = np.asarray(
        render_samples_sharded(scene_r, options, cameras, width, height, mesh)
    )

    from dxrexperiments_tpu.trace.integrator import render_sample

    singles = [
        np.asarray(render_sample(scene, options, c, width, height)["color"])
        for c in cams
    ]
    np.testing.assert_allclose(sharded, np.mean(singles, axis=0), atol=1e-5)


@needs_devices(8)
def test_progressive_step_sharded_accumulates():
    width, height = 32, 32
    scene, options, cams, accum = setup(width, height, 2)
    cameras = stack_cameras(cams)
    mesh = make_render_mesh(n_tile=4, n_spp=2)
    scene_r = replicate_scene(scene, mesh)
    accum = jax.device_put(accum, NamedSharding(mesh, P("tile", None, None)))

    out = progressive_step_sharded(
        scene_r, options, cameras, accum, width, height, mesh
    )
    arr = np.asarray(out)
    assert arr.shape == (height, width, 3)
    assert np.isfinite(arr).all() and arr.max() > 0
    # Output keeps the row sharding (trailing Nones are normalized away).
    assert out.sharding.spec in (P("tile"), P("tile", None, None))


@needs_devices(8)
def test_graft_dryrun_multichip():
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(8)


def test_graft_entry_compiles():
    from __graft_entry__ import entry

    fn, args = entry()
    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    out = compiled(*args)
    assert np.isfinite(np.asarray(out)).all()


@needs_devices(8)
def test_sharded_fused_progressive_matches_single_chip():
    """The shard_map progressive step (wavefront rows over "tile" via
    row0/full_height, samples over "spp", one psum) must reproduce the
    single-device production step — global NDC and global TEA pixel seeds
    are what make row shards equivalent."""
    from dxrexperiments_tpu.models.progressive import make_progressive_step

    width = height = 32
    scene, options, cams, accum = setup(width, height, 2)
    cameras = stack_cameras(cams)
    maxit = jnp.asarray(64, jnp.int32)

    step1 = make_progressive_step(scene, width, height, samples_per_step=2)
    want = np.asarray(
        step1(accum, options, cameras, scene["lights"], scene["env"], maxit)
    )

    mesh = make_render_mesh(n_tile=4, n_spp=2)
    step = make_sharded_progressive_step(
        scene, width, height, mesh, samples_per_step=2,
    )
    accum_s = jax.device_put(
        jnp.zeros((height, width, 3), jnp.float32),
        NamedSharding(mesh, P("tile", None, None)),
    )
    got = np.asarray(
        step(accum_s, options, cameras, scene["lights"], scene["env"], maxit)
    )
    np.testing.assert_allclose(got, want, atol=1e-6)


@needs_devices(8)
def test_sharded_realtime_denoise_matches_single_chip():
    """Row-sharded realtime + halo-exchange denoiser vs the single-chip
    pipeline, at both shard heights: >= the 25-row filter halo (ppermute
    halo path) and below it (all_gather fallback)."""
    from dxrexperiments_tpu.models.denoise import (
        default_denoise_params,
        denoise_composite,
    )
    from dxrexperiments_tpu.trace.integrator import render_sample

    width, height = 32, 64
    scene, options, cams, _ = setup(width, height, 1)
    cam = cams[0]
    dp = default_denoise_params()

    ref = render_sample(
        scene, options, cam, width, height, mode="realtime",
        jitter_scale=10.0, env_kind=int(scene["env"]["kind"]),
    )
    want = np.asarray(
        denoise_composite(ref["direct"], ref["indirect_specular"], dp)
    )

    for n_tile in (2, 8):  # 32 rows/shard (halo) and 8 rows (all_gather)
        mesh = make_render_mesh(
            n_tile=n_tile, n_spp=1, devices=jax.devices()[:n_tile]
        )
        step = make_sharded_realtime_step(
            scene, width, height, mesh, denoise=True
        )
        outs = step(options, cam, scene["lights"], scene["env"], dp)
        np.testing.assert_allclose(
            np.asarray(outs["display"]), want, atol=1e-5,
            err_msg=f"n_tile={n_tile}",
        )
        np.testing.assert_allclose(
            np.asarray(outs["color"]), np.asarray(ref["color"]), atol=1e-6
        )


@needs_devices(8)
def test_headless_shard_flag(tmp_path):
    """--shard end-to-end through the CLI (progressive 4x2 and realtime
    +denoise 8x1 on the virtual mesh)."""
    from dxrexperiments_tpu.app.headless import main

    out = tmp_path / "s.png"
    assert main([
        "--scene", "cornell-glossy", "--size", "32x32", "--spp", "2",
        "--shard", "4x2", "-o", str(out),
    ]) == 0
    assert out.exists()
    out2 = tmp_path / "s2.png"
    assert main([
        "--pipeline", "realtime", "--denoise", "--scene", "cornell-glossy",
        "--size", "32x32", "--shard", "8x1", "-o", str(out2),
    ]) == 0
    assert out2.exists()


@pytest.mark.slow
def test_sharded_two_level_matches_single_chip():
    """Tile/spp-sharded rendering of a TWO-LEVEL (TLAS/BLAS) scene on the
    virtual 8-device mesh must match the unsharded render — the multi-chip
    axis composes with the refittable instance path (scene replicated,
    including the host-static tlas metadata)."""
    from dxrexperiments_tpu.app.headless import build_scene
    from dxrexperiments_tpu.core.camera import camera_params
    from dxrexperiments_tpu.trace.integrator import default_options, render_sample

    width = height = 32
    sc, cam = build_scene("instanced:2")
    cam.set_aspect(width, height)
    scene = sc.build_two_level()
    options = default_options()
    cams = [camera_params(cam, frame_count=i) for i in range(4)]
    cameras = stack_cameras(cams)

    mesh = make_render_mesh(n_tile=2, n_spp=4)
    scene_r = replicate_scene(scene, mesh)
    sharded = np.asarray(
        render_samples_sharded(scene_r, options, cameras, width, height, mesh)
    )
    singles = [
        np.asarray(render_sample(scene, options, c, width, height)["color"])
        for c in cams
    ]
    np.testing.assert_allclose(sharded, np.mean(singles, axis=0), atol=1e-5)


@needs_devices(2)
def test_sharded_realtime_env_deferred_matches_single_chip():
    """Row-sharded realtime on the BVH route under a texture environment:
    each shard looks up its own rows' environment texels (row0 offset) and
    must match the single-device render."""
    from dxrexperiments_tpu.core.camera import Camera, camera_params
    from dxrexperiments_tpu.scene import Scene, cornell_box, envmap
    from dxrexperiments_tpu.scene.lights import (
        directional_light,
        point_light,
    )
    from dxrexperiments_tpu.trace.integrator import (
        default_options,
        render_sample,
    )

    width, height = 32, 64
    mesh0, materials = cornell_box(glossy_tall_box=True)
    sc = Scene()
    for m in materials:
        sc.add_material(m)
    sc.add_model(mesh0)
    sc.lights = {
        "dir": directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
        "point": point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0)),
    }
    rs = np.random.default_rng(3)
    sc.environment = envmap.cubemap_env(
        rs.uniform(0, 2, (6, 8, 8, 3)).astype(np.float32), strength=1.3
    )
    scene = sc.build(accel="bvh")
    options = default_options()
    cam = Camera()
    cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    cam.set_aspect(width, height)
    camp = camera_params(cam, jitter=(0.003, -0.002), frame_count=5)

    ref = render_sample(
        scene, options, camp, width, height, mode="realtime",
        jitter_scale=10.0, env_kind=int(scene["env"]["kind"]),
    )
    mesh = make_render_mesh(n_tile=2, n_spp=1, devices=jax.devices()[:2])
    step = make_sharded_realtime_step(
        scene, width, height, mesh, denoise=False
    )
    from dxrexperiments_tpu.models.denoise import default_denoise_params

    outs = step(
        options, camp, scene["lights"], scene["env"], default_denoise_params()
    )
    for k in ("color", "direct", "indirect_specular"):
        np.testing.assert_allclose(
            np.asarray(outs[k]), np.asarray(ref[k]), atol=1e-5, err_msg=k
        )


@pytest.mark.slow
def test_multiproc_dryrun_two_hosts():
    """Multi-HOST path (VERDICT r3 #5): two OS processes x 4 virtual CPU
    devices joined via jax.distributed (Gloo as the DCN stand-in), running
    the sharded progressive step over the global 4x2 mesh with the tile
    axis spanning the process boundary; each worker asserts equivalence
    with the single-process render (benchmarks/multiproc_dryrun.py)."""
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "benchmarks/multiproc_dryrun.py"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=dict(os.environ, DXR_MP_PORT="12377"),
        capture_output=True,
        text=True,
        timeout=590,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("MULTIPROC_DRYRUN_OK") == 2, r.stdout
