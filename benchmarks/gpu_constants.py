"""Measure the scene constants on the GPU: the triangle count above which
a scene gets a BVH (scene.BVH_THRESHOLD), the BVH leaf size
(scene.BVH_LEAF_SIZE), and whether geometry baked into the compiled step as
constants beats geometry passed as arguments.

    python benchmarks/gpu_constants.py [--parts threshold,leaf,geometry]
                                       [--out FILE]

Each measurement prints one JSON line (and appends it to --out): the
configuration, the first call's seconds (compile + one step) and the median
of five steady step times. Every step is one progressive sample at 512x512
through make_progressive_step. Fails without a GPU.

The threshold part renders the ``instanced:K`` grid (K x K spheres of 960
triangles on a 2-triangle floor) at K = 1..8, i.e. 962 to 61,442
triangles, once by brute force and once through the walk.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZE = 512
REPS = 5
THRESHOLD_GRIDS = (1, 2, 3, 4, 5, 6, 8)
LEAF_SIZES = (4, 8, 16)
GEOMETRY_SCENES = ("cornell-glossy", "instanced:32")


def _time_step(step, scene, cam, size=SIZE, reps=REPS):
    """(seconds of the first call, median seconds of `reps` more)."""
    import jax
    import jax.numpy as jnp

    from dxrexperiments_tpu.core.camera import camera_params
    from dxrexperiments_tpu.trace.integrator import default_options

    accum = jnp.zeros((size, size, 3), jnp.float32)
    maxit = jnp.asarray(1 << 20, jnp.int32)

    def run(i):
        cp = camera_params(cam, jitter=(0.1 / size, -0.1 / size),
                           frame_count=i)
        return jax.block_until_ready(
            step(accum, default_options(), cp, scene["lights"], scene["env"],
                 maxit))

    t0 = time.perf_counter()
    run(0)
    first = time.perf_counter() - t0
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        run(i + 1)
        times.append(time.perf_counter() - t0)
    times.sort()
    return first, times[len(times) // 2]


def constants_step(step):
    """`step` with its scene's geometry closed over, so XLA compiles the
    arrays into the program as constants instead of taking them as
    arguments."""
    import jax

    return jax.jit(lambda accum, options, camera, lights, env, maxit:
                   step(accum, options, camera, lights, env, maxit))


def measure(parts, emit, size=SIZE, grids=THRESHOLD_GRIDS, leaves=LEAF_SIZES,
            leaf_scene="instanced:32", geometry_scenes=GEOMETRY_SCENES):
    """Run the requested parts, calling ``emit(**record)`` per measurement."""
    import jax

    from dxrexperiments_tpu.app.headless import build_scene
    from dxrexperiments_tpu.models.progressive import make_progressive_step
    from dxrexperiments_tpu.scene import scene as scene_mod
    from dxrexperiments_tpu.trace.integrator import scene_geometry

    def scene_for(name, **build_kw):
        sc, cam = build_scene(name)
        cam.set_aspect(size, size)
        t0 = time.perf_counter()
        scene = sc.build(**build_kw)
        return scene, cam, time.perf_counter() - t0

    def timed(scene, cam, step=None):
        step = step or make_progressive_step(scene, size, size)
        return _time_step(step, scene, cam, size)

    # 1. Brute force against the walk, over scenes on both sides of the
    #    threshold.
    for k in grids if "threshold" in parts else ():
        for accel in ("none", "bvh"):
            scene, cam, build_s = scene_for(f"instanced:{k}", accel=accel)
            first, step_s = timed(scene, cam)
            emit(what="threshold", scene=f"instanced:{k}",
                 tris=int(scene["num_tris"]), accel=accel,
                 host_build_s=build_s, first_s=first, step_s=step_s)

    # 2. Leaf size of the walk on the 983k-triangle instanced scene.
    default_leaf = scene_mod.BVH_LEAF_SIZE
    try:
        for leaf in leaves if "leaf" in parts else ():
            scene_mod.BVH_LEAF_SIZE = leaf
            scene, cam, build_s = scene_for(leaf_scene)
            first, step_s = timed(scene, cam)
            emit(what="leaf_size", scene=leaf_scene,
                 tris=int(scene["num_tris"]), leaf=leaf,
                 host_build_s=build_s, first_s=first, step_s=step_s)
    finally:
        scene_mod.BVH_LEAF_SIZE = default_leaf

    # 3. Geometry as step arguments (the production step) or as constants.
    for name in geometry_scenes if "geometry" in parts else ():
        scene, cam, _ = scene_for(name)
        geo_bytes = sum(int(x.nbytes)
                        for x in jax.tree.leaves(scene_geometry(scene)))
        step = make_progressive_step(scene, size, size)
        for mode, fn in (("arguments", step), ("constants", constants_step(step))):
            first, step_s = timed(scene, cam, fn)
            emit(what="geometry", scene=name, tris=int(scene["num_tris"]),
                 mode=mode, geo_bytes=geo_bytes, first_s=first, step_s=step_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="append JSON lines here")
    ap.add_argument("--parts", default="threshold,leaf,geometry")
    args = ap.parse_args(argv)

    import jax

    from dxrexperiments_tpu.utils.runtime import (
        card_description, check_platform, enable_compile_cache,
    )

    check_platform("gpu", jax.devices())
    enable_compile_cache()
    card = card_description()
    kind = jax.devices()[0].device_kind
    print(f"card: {card} | device_kind {kind}", flush=True)

    def emit(**rec):
        rec.update(card=card, device_kind=kind)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")

    measure(args.parts.split(","), emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
