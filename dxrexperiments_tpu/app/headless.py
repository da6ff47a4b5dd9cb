"""Headless CLI renderer — the framework's primary end-to-end surface.

Replaces the reference's Win32 shell + frame loop
(/root/reference/src/Main.cpp, Win32Application.cpp, DXRExperimentsApp.cpp)
for CI/batch use: build a scene, run N progressive samples or the realtime
pipeline + denoiser, write a PNG, print fps / MRays/s stats.

Usage:
    python -m dxrexperiments_tpu.app.headless --scene cornell --size 512x512 \
        --spp 16 -o out.png
    python -m dxrexperiments_tpu.app.headless --pipeline realtime --denoise \
        --scene cornell-glossy --size 1920x1080 -o rt.png
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..core.camera import Camera
from ..models.denoise import DenoiseCompositor
from ..models.progressive import ProgressiveRaytracingPipeline
from ..models.realtime import RealtimeRaytracingPipeline
from ..scene import Scene, cornell_box, envmap, load_mesh
from ..scene.materials import Material
from ..scene.lights import default_lights, point_light, directional_light
from ..utils.image import write_png
from ..utils.runtime import PLATFORMS, enable_compile_cache, select_platform
from ..utils.stats import FrameStats
from ..models.denoise import reinhard_tonemap, linear_to_srgb
import jax.numpy as jnp


def build_scene(name: str) -> tuple[Scene, Camera]:
    cam = Camera()
    sc = Scene()
    if name.startswith("soup:"):
        # N random triangles — BVH stress scene (BASELINE config 5 scale).
        from ..scene.procedural import random_triangle_soup

        n = int(name.split(":", 1)[1])
        sc.add_model(random_triangle_soup(n, seed=0, extent=10.0))
        sc.lights = default_lights()
        sc.environment = envmap.gradient_env()
        cam.set_eye_at_up((25.0, 18.0, 25.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
        return sc, cam
    if name.startswith("instanced:"):
        # K x K grid of sphere instances (~1k tris each) with per-instance
        # transforms and alternating materials — the instancing config.
        from ..scene.procedural import sphere_mesh

        k = int(name.split(":", 1)[1])
        base = sphere_mesh((0.0, 0.0, 0.0), 1.0, lat=16, lon=32)
        glossy = sc.add_material(Material.reference_default())
        white = sc.add_material(Material(albedo=(0.73, 0.73, 0.73, 1.0)))
        for i in range(k):
            for j in range(k):
                t = np.eye(4, dtype=np.float32)
                t[0, 3] = (i - k / 2) * 2.5
                t[2, 3] = (j - k / 2) * 2.5
                t[1, 3] = 1.0
                sc.add_model(base, transform=t, material=glossy if (i + j) % 2 else white)
        floor_ext = k * 2.5
        from ..scene.mesh import Mesh

        floor = Mesh(
            np.array(
                [[-floor_ext, 0, -floor_ext], [-floor_ext, 0, floor_ext],
                 [floor_ext, 0, floor_ext], [floor_ext, 0, -floor_ext]],
                np.float32,
            ),
            None,
            np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        )
        sc.add_model(floor, material=white)
        sc.lights = default_lights()
        sc.environment = envmap.gradient_env()
        cam.set_eye_at_up(
            (floor_ext * 0.9, floor_ext * 0.5, floor_ext * 0.9),
            (0.0, 1.0, 0.0),
            (0.0, 1.0, 0.0),
        )
        return sc, cam
    if name == "config2":
        # BASELINE config 2 AS WRITTEN: multi-mesh Assimp-format scene
        # (susanne OBJ + ground FBX), geometry TEXTURES, and an area light
        # with soft shadows, under the reference's cathedral radiance
        # cubemap. Asset paths follow the reference repo
        # (/root/reference/src/DXRExperimentsApp.cpp:86-92).
        from ..scene.lights import area_light
        from ..scene.textures import checker_texture, planar_uvs
        from ..utils.dds import load_cubemap

        ref = "/root/reference/assets"
        sus = load_mesh(f"{ref}/models/susanne.obj")
        gnd = load_mesh(f"{ref}/models/ground.fbx")
        planar_uvs(gnd, scale=40.0)
        glossy = sc.add_material(Material.reference_default())
        floor = sc.add_material(Material(
            albedo=(0.85, 0.85, 0.85, 1.0), roughness=0.9,
            albedo_texture=checker_texture(
                16, (1.0, 1.0, 1.0), (0.45, 0.42, 0.38), size=128
            ),
        ))
        t = np.eye(4, dtype=np.float32)
        t[:3, :3] *= 4.0
        t[1, 3] = 4.2
        sc.add_model(sus, transform=t, material=glossy)
        sc.add_model(gnd, material=floor)
        sc.lights = {
            "dir": [directional_light((0.3, -0.75, -0.6), (1.0, 0.96, 0.9, 1.2))],
            "point": [],
            "area": [area_light(
                (-6.0, 14.0, 6.0), (4.0, 0, 0), (0, 0, -4.0),
                (1.0, 0.95, 0.85, 3.0),
            )],
        }
        sc.environment = envmap.cubemap_env(
            load_cubemap(f"{ref}/textures/CathedralRadiance.dds")
        )
        cam.set_eye_at_up((8.0, 7.0, 16.0), (0.0, 4.0, 0.0), (0.0, 1.0, 0.0))
        return sc, cam
    if name in ("cornell", "cornell-glossy", "cornell-tex", "cornell-glass"):
        mesh, materials = cornell_box(
            glossy_tall_box=(name in ("cornell-glossy", "cornell-glass")),
            textured_floor=(name == "cornell-tex"),
        )
        for m in materials:
            sc.add_material(m)
        if name == "cornell-glass":
            # a thin GLASS pane in front of the boxes — pair with
            # --refraction for the beyond-reference transmission bounce
            # (trace/integrator.py). A pane (one interface per ray) fits
            # the parity-bounded depth-1 recursion; a solid glass volume
            # would need an exit bounce.
            from ..scene.materials import MATERIAL_GLASS
            from ..scene.mesh import Mesh

            glass = sc.add_material(Material(
                albedo=(0.02, 0.02, 0.02, 1.0),
                specular=(0.04, 0.04, 0.04, 1.0),
                reflectivity=1.0,
                roughness=0.0,
                ior=1.5,
                type=MATERIAL_GLASS,
            ))
            pane = np.array(
                [[-0.85, 0.15, 0.55], [-0.85, 1.55, 0.55],
                 [0.15, 1.55, 0.55], [0.15, 0.15, 0.55]], np.float32
            )
            sc.add_model(
                Mesh(pane, None,
                     np.array([[0, 2, 1], [0, 3, 2]], np.int32)),
                material=glass,
            )
        sc.add_model(mesh)
        if name == "cornell-tex":
            # BASELINE config 2 feature demo: textured albedo + quad area
            # light with stratified soft shadows (scene/textures.py,
            # scene/lights.area_light).
            from ..scene.lights import area_light

            sc.lights = {
                "dir": [directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.3))],
                "point": [],
                "area": [area_light(
                    (-0.4, 1.96, -0.4), (0.8, 0, 0), (0, 0, 0.8),
                    (1.0, 0.9, 0.7, 4.0),
                )],
            }
        else:
            sc.lights = {
                "dir": directional_light((0.0, -0.6, -0.8), (0.9, 0.9, 0.9, 0.6)),
                "point": point_light((0.0, 1.8, 0.0), (1.0, 0.9, 0.7, 6.0)),
            }
        sc.environment = envmap.constant_env((0.0, 0.0, 0.0))
        cam.set_eye_at_up((0.0, 1.0, 3.4), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    else:
        # Treat as a mesh file path; reference-like default framing
        # (/root/reference/src/DXRExperimentsApp.cpp:60-63).
        mesh = load_mesh(name)
        sc.add_model(mesh, material=Material.reference_default())
        sc.lights = default_lights()
        sc.environment = envmap.gradient_env()
        lo, hi = mesh.aabb()
        center = (lo + hi) / 2
        extent = float(np.linalg.norm(hi - lo))
        eye = center + np.array([0.3, 0.35, 1.0]) * extent
        cam.set_eye_at_up(eye, center, (0.0, 1.0, 0.0))
    return sc, cam


def parse_env(spec: str) -> dict:
    """--env parser: kind[:arg][ xStrength]. Replaces the reference's
    hardcoded HDR/cubemap loads
    (/root/reference/src/ProgressiveRaytracingPipeline.cpp:111-118)."""
    strength = 1.0
    if " x" in spec:
        spec, s = spec.rsplit(" x", 1)
        strength = float(s)
    kind, _, arg = spec.partition(":")
    if kind == "gradient":
        return envmap.gradient_env(strength=strength)
    if kind == "constant":
        rgb = tuple(float(v) for v in arg.split(",")) if arg else (0.0, 0.0, 0.0)
        return envmap.constant_env(rgb, strength=strength)
    if kind == "latlong":
        from ..utils.image import read_image

        return envmap.latlong_env(read_image(arg), strength=strength)
    if kind == "cubemap":
        from ..utils.dds import load_cubemap

        return envmap.cubemap_env(load_cubemap(arg), strength=strength)
    raise ValueError(f"unknown env spec {spec!r}")


def _main_sharded(args, scene, camera, width, height) -> int:
    """--shard path: multi-chip rendering over a (tile, spp) device mesh.

    The multi-device productization of parallel/render.py: progressive
    shards image rows over "tile" and the per-step sample batch over "spp";
    realtime shards rows through the wavefront AND the halo-exchange
    denoiser. Exercisable on one device (1x1) or on the virtual CPU mesh
    (JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..core.camera import camera_params
    from ..models.denoise import default_denoise_params
    from ..trace.integrator import default_options
    from ..parallel import (
        make_render_mesh,
        make_sharded_progressive_step,
        make_sharded_realtime_step,
        replicate_scene,
        stack_cameras,
    )

    n_dev = len(jax.devices())
    if args.shard == "auto":
        n_tile, n_spp = n_dev, 1
    else:
        try:
            n_tile, n_spp = (int(x) for x in args.shard.lower().split("x"))
        except ValueError:
            print(f"invalid --shard {args.shard!r} (want TILExSPP or auto)")
            return 2
    if n_tile * n_spp > n_dev:
        print(f"--shard {n_tile}x{n_spp} needs {n_tile * n_spp} devices, "
              f"have {n_dev}")
        return 2
    mesh = make_render_mesh(
        n_tile=n_tile, n_spp=n_spp,
        devices=jax.devices()[: n_tile * n_spp],
    )
    rng = np.random.default_rng(args.seed)

    if args.pipeline == "progressive":
        scene_data = (
            scene.build_two_level() if args.accel == "two-level"
            else scene.build()
        )
        step = make_sharded_progressive_step(
            scene_data, width, height, mesh, samples_per_step=n_spp,
            ao_only=args.ao_only,
        )
        accum = jax.device_put(
            jnp.zeros((height, width, 3), jnp.float32),
            NamedSharding(mesh, P("tile", None, None)),
        )
        maxit = jnp.asarray(max(args.spp, 1), jnp.int32)
        # Per-step constants live on the mesh once, not copied every step.
        options, lights, env, maxit = replicate_scene(
            (default_options(), scene_data["lights"], scene_data["env"],
             maxit), mesh)
        steps = -(-args.spp // n_spp)
        t0 = time.perf_counter()
        for frame in range(steps):
            cams = [
                camera_params(
                    camera,
                    jitter=((rng.random() - 0.5) / width,
                            (rng.random() - 0.5) / height),
                    frame_count=frame * n_spp + k,
                    accum_count=frame * n_spp,
                )
                for k in range(n_spp)
            ]
            accum = step(accum, options, stack_cameras(cams), lights, env,
                         maxit)
        out = accum
        out.block_until_ready()
        dt = time.perf_counter() - t0
        img = np.asarray(out)
        if args.tonemap:
            img = np.asarray(
                linear_to_srgb(reinhard_tonemap(jnp.asarray(img)),
                               jnp.asarray(2.2))
            )
        spp = steps * n_spp
        print(
            f"progressive sharded {n_tile}x{n_spp}: {spp} spp at "
            f"{width}x{height} in {dt:.2f}s ({spp / dt:.2f} spp/s, "
            f"~{width*height*spp/dt/1e6:.1f} Mprimary-rays/s)"
        )
    else:
        scene_data = scene.build()
        step = make_sharded_realtime_step(
            scene_data, width, height, mesh, denoise=True,
        )
        dparams = default_denoise_params()
        t0 = time.perf_counter()
        cam = camera_params(
            camera,
            jitter=((rng.random() - 0.5) / width,
                    (rng.random() - 0.5) / height),
            frame_count=0,
        )
        outs = step(
            default_options(), cam, scene_data["lights"],
            scene_data["env"], dparams,
        )
        final = outs["display"] if args.denoise else (
            outs["direct"] + outs["indirect_specular"]
        )
        final.block_until_ready()
        dt = time.perf_counter() - t0
        img = np.clip(np.asarray(final), 0.0, 1.0)
        print(
            f"realtime sharded {n_tile}x{n_spp}"
            f"{'+denoise' if args.denoise else ''}: {width}x{height} "
            f"in {dt:.2f}s"
        )

    img = np.clip(img, 0.0, 1.0)
    write_png(args.output, img)
    print(f"wrote {args.output} (mean {img.mean():.4f}, max {img.max():.4f})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--scene", default="cornell",
        help="cornell | cornell-glossy | cornell-glass (pair with"
        " --refraction) | cornell-tex (textured floor + area"
        " light) | soup:N | instanced:K | mesh file path",
    )
    ap.add_argument("--size", default="512x512")
    ap.add_argument("--spp", type=int, default=16, help="progressive samples")
    ap.add_argument("--pipeline", choices=["progressive", "realtime"], default="progressive")
    ap.add_argument("--denoise", action="store_true", help="realtime: run DenoiseCompositor")
    ap.add_argument(
        "--frames-in-flight", type=int, default=1, metavar="K",
        help="realtime: batch K frames (raytrace+denoise) per dispatch — "
        "the reference's 3-deep frame ring as a dispatch batch; amortizes "
        "per-dispatch cost at K frames of input latency",
    )
    ap.add_argument(
        "--temporal",
        type=float,
        default=None,
        metavar="ALPHA",
        help="realtime: temporal accumulation blend factor (e.g. 0.2)",
    )
    ap.add_argument("--ao-only", action="store_true")
    ap.add_argument(
        "--refraction",
        action="store_true",
        help="progressive: trace a transmission bounce through glass "
        "materials (BEYOND-reference opt-in; the DXR app's glass only "
        "reflects)",
    )
    ap.add_argument(
        "--aov",
        default=None,
        choices=["albedo", "direct", "indirect-diffuse", "indirect-specular", "fresnel"],
        help="debug AOV view (progressive pipeline)",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--env",
        default=None,
        help="environment override: gradient | constant:R,G,B | "
        "latlong:path(.hdr/.jpg/.png) | cubemap:path(.dds) "
        "[xStrength suffix, e.g. gradient x2.0]",
    )
    ap.add_argument("--tonemap", action="store_true", help="Reinhard+gamma the progressive output")
    ap.add_argument(
        "--save-state", default=None, metavar="PATH",
        help="progressive: write the accumulation checkpoint (accum image, "
        "count, camera VP, RNG state, frame index) to PATH.npz when the "
        "render finishes — the device-lost-recovery analogue "
        "(DeviceResources.cpp:447-487) made durable",
    )
    ap.add_argument(
        "--checkpoint-every", type=int, default=0, metavar="N",
        help="progressive: also write --save-state every N frames, so a "
        "long render survives a process death mid-run",
    )
    ap.add_argument(
        "--resume", default=None, metavar="PATH",
        help="progressive: resume from a --save-state checkpoint; the "
        "continuation is bit-identical to the uninterrupted render "
        "(same RNG draw sequence, same accumulation)",
    )
    ap.add_argument(
        "--accel",
        default="auto",
        choices=["auto", "two-level"],
        help="acceleration structure: auto = flattened world-space build "
        "(BVH above the size threshold); two-level = shared per-mesh BLAS + "
        "refittable instance TLAS (the RtScene analogue; required for "
        "--animate-instances)",
    )
    ap.add_argument(
        "--animate-instances",
        action="store_true",
        help="spin instance transforms each frame via TLAS refit "
        "(two-level scenes; no re-bake, no recompile)",
    )
    ap.add_argument(
        "--platform",
        default=None,
        choices=PLATFORMS,
        help="run on this JAX platform or fail (default: JAX's own choice)",
    )
    ap.add_argument(
        "--shard",
        default=None,
        metavar="TILExSPP",
        help="multi-chip rendering over a (tile, spp) device mesh, e.g. "
        "'4x2' = image rows over 4 devices x samples over 2; 'auto' puts "
        "every device on the tile axis. Progressive shards rows+samples "
        "(one psum-mean per step); realtime shards rows incl. the halo-"
        "exchange denoiser. Single-device meshes work (a 1x1 'mesh' is the "
        "single-chip path through the sharded code).",
    )
    ap.add_argument("-o", "--output", default="out.png")
    args = ap.parse_args(argv)

    try:
        select_platform(args.platform)
    except RuntimeError as e:
        ap.error(str(e))
    enable_compile_cache()

    if (args.save_state or args.resume) and args.pipeline != "progressive":
        ap.error("--save-state/--resume checkpoint the progressive "
                 "accumulation state; use --pipeline progressive")
    if (args.save_state or args.resume) and args.shard:
        ap.error("--save-state/--resume is the single-process path; "
                 "combine with --shard is not supported")
    if args.checkpoint_every and not args.save_state:
        ap.error("--checkpoint-every needs --save-state PATH")
    if args.frames_in_flight < 1:
        ap.error(f"--frames-in-flight must be >= 1 (got {args.frames_in_flight})")
    if args.frames_in_flight > 1 and args.pipeline != "realtime":
        ap.error("--frames-in-flight is the realtime frames-in-flight batch; "
                 "it has no effect on --pipeline progressive")
    args.spp = max(args.spp, 1)
    width, height = (int(x) for x in args.size.lower().split("x"))
    if width < 1 or height < 1:
        ap.error(f"invalid --size {args.size!r}")
    scene, camera = build_scene(args.scene)
    if args.env:
        scene.environment = parse_env(args.env)
    camera.set_aspect(width, height)
    stats = FrameStats(width, height)

    if args.shard:
        return _main_sharded(args, scene, camera, width, height)

    if args.pipeline == "progressive":
        pipe = ProgressiveRaytracingPipeline(width, height, seed=args.seed)
        pipe.max_iterations = max(args.spp, 1)
        pipe.ao_only = args.ao_only
        pipe.refraction = args.refraction
        if args.aov:
            key = {
                "albedo": "show_gbuffer_albedo_only",
                "direct": "show_direct_lighting_only",
                "indirect-diffuse": "show_indirect_diffuse_only",
                "indirect-specular": "show_indirect_specular_only",
                "fresnel": "show_fresnel_term",
            }[args.aov]
            pipe.options[key] = jnp.asarray(True)
        pipe.set_camera(camera)
        if args.accel == "two-level" or args.animate_instances:
            pipe.set_scene_data(scene.build_two_level())
        else:
            pipe.set_scene(scene)
        base_tf = np.stack([inst.transform for inst in scene.instances])

        start_frame = 0
        if args.resume:
            done = pipe.load_checkpoint(args.resume)
            start_frame = done if done is not None else pipe.accum_count
            print(f"resumed {args.resume}: {pipe.accum_count} accumulated "
                  f"samples, continuing at frame {start_frame}")

        # Resuming an already-complete checkpoint (start_frame >= spp) must
        # emit the accumulated image, not crash on an unbound `out`.
        out = pipe.accum
        t0 = time.perf_counter()
        for frame in range(start_frame, args.spp):
            if args.animate_instances:
                yaw = 0.05 * frame
                c, s = np.cos(yaw), np.sin(yaw)
                rot = np.eye(4, dtype=np.float32)
                rot[0, 0], rot[0, 2], rot[2, 0], rot[2, 2] = c, s, -s, c
                pipe.set_instance_transforms(
                    jnp.asarray(np.einsum("ij,njk->nik", rot, base_tf))
                )
            pipe.update(elapsed_time=frame / 60.0, elapsed_frames=frame)
            out = pipe.render()
            stats.frame()
            if (
                args.save_state
                and args.checkpoint_every
                and (frame + 1) % args.checkpoint_every == 0
                and frame + 1 < args.spp
            ):
                pipe.save_checkpoint(args.save_state, frames_done=frame + 1)
        out.block_until_ready()
        if args.save_state:
            pipe.save_checkpoint(args.save_state, frames_done=args.spp)
        dt = time.perf_counter() - t0
        img = np.asarray(out)
        if args.tonemap:
            img = np.asarray(linear_to_srgb(reinhard_tonemap(jnp.asarray(img)), jnp.asarray(2.2)))
        print(
            f"progressive: {args.spp} spp at {width}x{height} in {dt:.2f}s "
            f"({args.spp / dt:.2f} spp/s, ~{width*height*args.spp/dt/1e6:.1f} Mprimary-rays/s)"
        )
    else:
        pipe = RealtimeRaytracingPipeline(width, height, seed=args.seed)
        pipe.set_camera(camera)
        pipe.set_scene(scene)
        denoiser = DenoiseCompositor(temporal_alpha=args.temporal)
        k = args.frames_in_flight
        t0 = time.perf_counter()
        if k > 1:
            # Frames-in-flight batch: K frames (raytrace + denoise) in ONE
            # dispatch — the analogue of the reference's 3-deep frame ring
            # (DeviceResources.cpp:580-598). Writes the LAST frame.
            if args.denoise and args.temporal is None:
                from ..models.realtime import make_realtime_denoise_frames_step

                step = make_realtime_denoise_frames_step(
                    pipe.scene_data, width, height, k
                )
                cams = pipe.frame_cameras(0, k)
                _, imgs = step(
                    pipe.options, cams, pipe.scene_data["lights"],
                    pipe.scene_data["env"], denoiser.params,
                )
                final = imgs[-1]
            elif args.denoise:
                # temporal: history scanned through the batch in-device
                d_k, s_k = pipe.render_frames(0, k)
                final = denoiser.dispatch_frames(d_k, s_k)[-1]
            else:
                d_k, s_k = pipe.render_frames(0, k)
                final = d_k[-1] + s_k[-1]
        else:
            pipe.update(elapsed_time=0.0, elapsed_frames=0)
            direct, indirect = pipe.render()
            if args.denoise:
                final = denoiser.dispatch(direct, indirect)
            else:
                final = direct + indirect
        final.block_until_ready()
        dt = time.perf_counter() - t0
        img = np.clip(np.asarray(final), 0.0, 1.0)
        suffix = "+denoise" if args.denoise else ""
        if k > 1:
            suffix += f" ({k} frames/dispatch, {dt/k*1000:.1f} ms/frame)"
        print(f"realtime{suffix}: {width}x{height} in {dt:.2f}s")

    img = np.clip(img, 0.0, 1.0)
    write_png(args.output, img)
    print(f"wrote {args.output} (mean {img.mean():.4f}, max {img.max():.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
