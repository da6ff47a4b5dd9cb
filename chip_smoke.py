"""Smoke test of the main render paths on the GPU, at the sizes users run.

    python chip_smoke.py               # phases 1-5 on one GPU
    python chip_smoke.py --four-cards  # only the sharded paths, on four GPUs

Everything runs in this one process: a JAX process reserves most of a card's
memory, so a second process on the card would fail. The script exits
non-zero, printing no result, when JAX's default device is not a GPU.

The first line names the card. Each phase prints one line of times (compile
seconds, ms per sample or frame, primary Mrays/s, peak device memory) and one
line per comparison, the measured error beside its limit. A failed comparison
raises, which ends the run with a non-zero exit. The last line is one JSON
object naming the device.

Phases (BASELINE.md configs 1, 4 and 5):

1. Progressive Cornell-glossy 512x512, 16 samples per dispatch, 64 spp. The
   same step at 4 spp is compared with its run on the host CPU, and a 64x64
   16-spp render with tests/golden_cornell_16spp.npz.
2. Realtime 1920x1080 + joint-bilateral denoise, 3 frames in flight, a few
   batches. One batch's AOVs and composites are compared with the CPU run.
3. Flattened ``instanced:32`` (983,042 triangles) through the BVH walk,
   512x512, 2 samples. Closest and any hits of 65,536 primary rays and of
   the bounce rays from those that hit are compared with brute force on the
   card (``ops/intersect.py``), with a textbook Möller–Trumbore written in
   this script (``plain_mt``, on the card; t recomputed in float64 on the
   host), and, for 256 rays, with the float64 host traversal
   ``accel.bvh.traverse_nodes_numpy``.
4. Two-level ``instanced:32`` with animated instances: 3 frames of device
   refit, then hits compared with the flattened walk over the same
   transforms.
5. The headless CLI end to end; the PNG is read back.

With ``--four-cards``: progressive Cornell-glossy 512x512, 64 spp at 16
samples per dispatch, on a 2x2 (tile x spp) mesh, and realtime 1920x1080 +
denoise on a 4x1 mesh (rows, with the denoiser's halo exchange), timed over
several frames; each is compared with the single-card render of the same
inputs. The per-step constants (options, lights, environment) are placed on
the mesh once, as the CLI's ``--shard`` path does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

# --------------------------------------------------------------------------- #
# Tolerances
# --------------------------------------------------------------------------- #
# A path tracer takes another branch wherever one float flips a predicate (a
# hit on a shared edge, a shadow ray grazing a corner), and the GPU's
# transcendentals and fused multiply-adds differ from the CPU's in the last
# bits. So two renders of the same inputs are compared by their image mean,
# which such flips barely move, and by the share of pixels that moved
# visibly; a wrong path (a lost light, a swapped material) fails both.
IMAGE_MEAN_REL = 1e-4  # |mean(got) - mean(want)| / mean(want)
PIXEL_ABS = 1e-2  # a pixel differs when any channel moved more than this
PIXEL_FRAC = 0.005  # share of pixels allowed to differ
# Hit records: the walk visits triangles in another order than brute force,
# so an exact tie on a shared edge may resolve to either triangle; a
# non-tied hit is the same triangle at the same distance up to rounding.
# Brute force (ops/intersect.py) shares the walk's hit predicate and its
# exact (t, u, v) recompute, so that comparison checks the traversal only.
# The intersection math is checked against plain_mt below, which rounds
# differently near edges (hence the same share, not all rays), with t of the
# agreed triangle recomputed in float64, and against the float64 host
# traversal.
HIT_TRI_AGREE = 0.999  # share of rays with the same triangle (or both miss)
HIT_T_REL = 1e-5  # max |t - t_ref| / t_ref where the triangle agrees
ANY_AGREE = 0.999  # share of shadow rays with the same occlusion flag
# Two-level against flattened: the geometry itself is rounded differently
# (world-space vertices on one side, the ray mapped into object space by a
# float32 inverse transform on the other). That is a few ulps of the
# coordinates (up to ~100 from the camera), grown without bound by 1/cos at
# grazing hits. So there t must agree within 1e-4 of max(t, 1 world unit)
# for the same share of rays as the triangle ids (at 512x512 one pixel spans
# ~1.5e-3 of the distance to the camera, fifteen times more); the largest
# difference is printed beside it.
TWO_LEVEL_T_REL = 1e-4


class CheckFailed(AssertionError):
    pass


class Checks:
    """Collects one phase's comparisons. Each prints its measured value
    beside its limit; ``done`` raises if any of them failed."""

    def __init__(self, phase: str):
        self.phase = phase
        self.failed: list[str] = []

    def at_most(self, name: str, value: float, limit: float) -> None:
        self._report(name, value, "<=", limit, value <= limit)

    def at_least(self, name: str, value: float, limit: float) -> None:
        self._report(name, value, ">=", limit, value >= limit)

    def _report(self, name, value, op, limit, ok) -> None:
        print(f"  check {self.phase} {name}: {value:.6g} {op} {limit:.6g} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failed.append(name)

    def done(self) -> None:
        if self.failed:
            raise CheckFailed(f"{self.phase}: failed {', '.join(self.failed)}")


def image_agreement(got, want) -> tuple[float, float]:
    """(relative difference of the image means, share of pixels whose
    largest channel difference exceeds PIXEL_ABS) for [..., H, W, C]."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise CheckFailed(f"shape {got.shape} != {want.shape}")
    if not np.isfinite(got).all():
        raise CheckFailed("non-finite values")
    mean_rel = abs(got.mean() - want.mean()) / max(abs(want.mean()), 1e-12)
    bad = (np.abs(got - want).max(axis=-1) > PIXEL_ABS).mean()
    return float(mean_rel), float(bad)


def check_images(checks: Checks, name: str, got, want) -> None:
    mean_rel, bad = image_agreement(got, want)
    checks.at_most(f"{name} mean rel diff", mean_rel, IMAGE_MEAN_REL)
    checks.at_most(f"{name} pixels > {PIXEL_ABS:g}", bad, PIXEL_FRAC)


def hit_agreement(tri, t, tri_ref, t_ref, t_floor=0.0):
    """(share of rays with the same triangle id, -1 for a miss; array of
    |t - t_ref| / max(|t_ref|, t_floor) over the rays that hit the same
    triangle)."""
    tri = np.asarray(tri)
    tri_ref = np.asarray(tri_ref)
    same = tri == tri_ref
    both = same & (tri_ref >= 0)
    t = np.asarray(t, np.float64)[both]
    t_ref = np.asarray(t_ref, np.float64)[both]
    scale = np.maximum(np.abs(t_ref), max(t_floor, 1e-12))
    return float(same.mean()), np.abs(t - t_ref) / scale


def check_hits(checks: Checks, name: str, tri, t, tri_ref, t_ref,
               t_floor=None) -> None:
    """Same triangle for HIT_TRI_AGREE of the rays, and where it is, t
    within HIT_T_REL relative; with t_floor (two-level against flattened),
    t within TWO_LEVEL_T_REL of max(t, t_floor) for HIT_TRI_AGREE of them."""
    agree, err = hit_agreement(tri, t, tri_ref, t_ref, t_floor or 0.0)
    worst = float(err.max()) if err.size else 0.0
    checks.at_least(f"{name} same triangle", agree, HIT_TRI_AGREE)
    if t_floor is None:
        checks.at_most(f"{name} t rel diff", worst, HIT_T_REL)
        return
    share = float((err <= TWO_LEVEL_T_REL).mean()) if err.size else 1.0
    checks.at_least(
        f"{name} share with t diff <= {TWO_LEVEL_T_REL:g} x max(t, "
        f"{t_floor:g}) (largest {worst:.3g})", share, HIT_TRI_AGREE)


def check_occlusion(checks: Checks, name: str, occ, occ_ref) -> None:
    agree = float((np.asarray(occ) == np.asarray(occ_ref)).mean())
    checks.at_least(f"{name} same occlusion", agree, ANY_AGREE)


# --------------------------------------------------------------------------- #
# Helpers
# --------------------------------------------------------------------------- #
def _timed(fn, *args, **kwargs):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def _peak_mib(device) -> float:
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 2**20


def _times_line(phase: str, device, compile_s: float, unit: str,
                per_unit_s: float, primary_rays_per_unit: int) -> None:
    mrays = primary_rays_per_unit / per_unit_s / 1e6
    print(f"phase {phase}: compile {compile_s:.2f} s, "
          f"{per_unit_s * 1e3:.3f} ms/{unit}, {mrays:.2f} primary Mrays/s, "
          f"peak {_peak_mib(device):.0f} MiB", flush=True)


def _first(tree):
    import jax

    return jax.tree.map(lambda x: x[0], tree)


def _stack(cams: list) -> dict:
    import jax
    import jax.numpy as jnp

    return jax.tree.map(lambda *xs: jnp.stack(xs), *cams)


def progressive_cameras(camera, width: int, height: int, spp: int,
                        per_step: int, seed: int = 0) -> list:
    """One stacked camera batch per dispatch: per-sample jitter drawn as the
    CLI draws it, frame_count = sample index, accum_count = samples so far."""
    from dxrexperiments_tpu.core.camera import camera_params

    rng = np.random.default_rng(seed)
    batches = []
    for base in range(0, spp, per_step):
        batches.append(_stack([
            camera_params(
                camera,
                jitter=((rng.random() - 0.5) / width,
                        (rng.random() - 0.5) / height),
                frame_count=base + k, accum_count=base,
            )
            for k in range(per_step)
        ]))
    return batches


def _scene(name: str, width: int, height: int):
    from dxrexperiments_tpu.app.headless import build_scene

    sc, cam = build_scene(name)
    cam.set_aspect(width, height)
    return sc, cam


def _accumulate(device, sc, width, height, batches, spp):
    """The production progressive step on `device`: `batches` folded into a
    zero accumulator. Returns the image as numpy."""
    import jax
    import jax.numpy as jnp

    from dxrexperiments_tpu.models.progressive import make_progressive_step
    from dxrexperiments_tpu.trace.integrator import default_options

    with jax.default_device(device):
        scene = sc.build()
        per_step = int(batches[0]["frame_count"].shape[0])
        step = make_progressive_step(
            scene, width, height, samples_per_step=per_step
        )
        accum = jnp.zeros((height, width, 3), jnp.float32)
        maxit = jnp.asarray(spp, jnp.int32)
        for cams in batches:
            accum = step(accum, default_options(), jax.device_put(cams, device),
                         scene["lights"], scene["env"], maxit)
        return np.asarray(accum)


# --------------------------------------------------------------------------- #
# Phases
# --------------------------------------------------------------------------- #
def phase_progressive(device, cpu, size=512, spp=64, per_step=16, cpu_spp=4):
    import jax
    import jax.numpy as jnp

    from dxrexperiments_tpu.models.progressive import (
        ProgressiveRaytracingPipeline, make_progressive_step,
    )
    from dxrexperiments_tpu.trace.integrator import default_options

    checks = Checks("1")
    sc, cam = _scene("cornell-glossy", size, size)
    scene = sc.build()
    batches = progressive_cameras(cam, size, size, spp, per_step)
    step = make_progressive_step(scene, size, size, samples_per_step=per_step)
    zero = jnp.zeros((size, size, 3), jnp.float32)
    maxit = jnp.asarray(spp, jnp.int32)
    args = (default_options(), batches[0], scene["lights"], scene["env"], maxit)
    _, first = _timed(step, zero, *args)

    def render_all():
        accum = zero
        for cams in batches:
            accum = step(accum, default_options(), cams, scene["lights"],
                         scene["env"], maxit)
        return accum

    img, total = _timed(render_all)
    per_sample = total / spp
    _times_line(f"1 progressive cornell-glossy {size}x{size} {spp} spp",
                device, first - total / len(batches), "sample", per_sample,
                size * size)
    img = np.asarray(img)
    if not (np.isfinite(img).all() and img.max() > 0):
        raise CheckFailed("1: progressive image is empty or non-finite")

    few = progressive_cameras(cam, size, size, cpu_spp, cpu_spp, seed=1)
    check_images(checks, f"{cpu_spp} spp vs CPU",
                 _accumulate(device, sc, size, size, few, cpu_spp),
                 _accumulate(cpu, sc, size, size, few, cpu_spp))

    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tests", "golden_cornell_16spp.npz"))["img"]
    g_size = golden.shape[0]
    gsc, gcam = _scene("cornell-glossy", 1, 1)
    pipe = ProgressiveRaytracingPipeline(g_size, g_size, seed=7)
    pipe.set_camera(gcam)
    pipe.set_scene(gsc)
    for f in range(16):
        pipe.update(elapsed_time=f / 60.0, elapsed_frames=f)
        pipe.render()
    check_images(checks, f"{g_size}x{g_size} 16 spp vs golden",
                 np.asarray(jax.block_until_ready(pipe.get_output())), golden)
    checks.done()


def phase_realtime(device, cpu, width=1920, height=1080, k=3, batches=4):
    import jax

    from dxrexperiments_tpu.models.denoise import default_denoise_params
    from dxrexperiments_tpu.models.realtime import (
        RealtimeRaytracingPipeline, make_realtime_denoise_frames_step,
    )
    from dxrexperiments_tpu.trace.integrator import default_options

    checks = Checks("2")
    sc, cam = _scene("cornell-glossy", width, height)
    pipe = RealtimeRaytracingPipeline(width, height, seed=0)
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    cams = [pipe.frame_cameras(i * k, k) for i in range(batches)]
    params = default_denoise_params()
    step = make_realtime_denoise_frames_step(pipe.scene_data, width, height, k)
    args = (pipe.scene_data["lights"], pipe.scene_data["env"], params)
    (aovs, display), first = _timed(step, default_options(), cams[0], *args)

    def render_all():
        return [step(default_options(), c, *args) for c in cams]

    _, total = _timed(render_all)
    per_frame = total / (batches * k)
    _times_line(f"2 realtime+denoise {width}x{height} {k} frames in flight",
                device, first - total / batches, "frame", per_frame,
                width * height)

    with jax.default_device(cpu):
        scene_c = sc.build()
        step_c = make_realtime_denoise_frames_step(scene_c, width, height, k)
        aovs_c, display_c = step_c(
            default_options(), jax.device_put(cams[0], cpu),
            scene_c["lights"], scene_c["env"], params,
        )
    for key in ("direct", "indirect_specular", "color"):
        check_images(checks, f"frame 0 {key} vs CPU", aovs[key][0],
                     aovs_c[key][0])
    check_images(checks, "composite vs CPU", display, display_c)
    checks.done()


def _primary_subset(cam_params, width, height, stride):
    import jax.numpy as jnp

    from dxrexperiments_tpu.core.camera import primary_ray_grid

    o, d = primary_ray_grid(cam_params, width, height, 30.0)
    return (jnp.asarray(o.reshape(-1, 3)[::stride]),
            jnp.asarray(d.reshape(-1, 3)[::stride]))


def _bounce_rays(o, d, t, geo_normal, seed):
    """Rays leaving each hit point into the hemisphere its normal faces
    (origins offset along that side of the normal)."""
    o, d, t, n = (np.asarray(x, np.float64) for x in (o, d, t, geo_normal))
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    n = np.where(np.sum(n * d, axis=-1, keepdims=True) > 0, -n, n)
    rng = np.random.default_rng(seed)
    w = rng.normal(size=o.shape)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    w = np.where(np.sum(w * n, axis=-1, keepdims=True) < 0, -w, w)
    p = o + t[:, None] * d + 1e-3 * n
    return p.astype(np.float32), w.astype(np.float32)


def _scalar_mt(v0, e1, e2, o, d):
    """Möller–Trumbore for one ray and one triangle in float64."""
    p = np.cross(d, e2)
    det = np.dot(e1, p)
    if abs(det) < 1e-12:
        return None
    inv = 1.0 / det
    tv = o - v0
    u = np.dot(tv, p) * inv
    if u < 0 or u > 1:
        return None
    q = np.cross(tv, e1)
    v = np.dot(d, q) * inv
    if v < 0 or u + v > 1:
        return None
    return np.dot(e2, q) * inv


def _vec_mt64(v0, e1, e2, o, d):
    """t of each ray against its own triangle by Möller–Trumbore in float64
    on the host (no bounds test: the caller picked the triangle)."""
    v0, e1, e2, o, d = (np.asarray(x, np.float64) for x in (v0, e1, e2, o, d))
    p = np.cross(d, e2)
    det = np.sum(e1 * p, axis=-1)
    q = np.cross(o - v0, e1)
    return np.sum(e2 * q, axis=-1) / np.where(det == 0.0, 1.0, det)


def plain_mt(v0, e1, e2, o, d, t_min, seg, cull_backface, chunk=1024):
    """Textbook Möller–Trumbore of every ray against every triangle on the
    default device, written here from the vertices alone: it shares no code
    with ops/intersect.py or the walk. Returns (closest triangle id or -1,
    whether any triangle lies in (t_min, seg)); the any-hit test never culls
    back faces, as shadow rays do not."""
    import jax
    import jax.numpy as jnp

    n = v0.shape[0]
    pad = -n % chunk
    tris = jnp.stack([jnp.pad(jnp.asarray(x, jnp.float32), ((0, pad), (0, 0)))
                      for x in (v0, e1, e2)])  # [3, T, 3]; padding never hits
    tris = tris.reshape(3, -1, chunk, 3).transpose(1, 0, 2, 3)

    def cross(a, b):
        return jnp.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                          a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                          a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)

    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    @jax.jit
    def run(o, d, seg, tris):
        def body(carry, xs):
            best_t, best_i, occ = carry
            (a, b, c), base = xs
            dd, oo = d[:, None], o[:, None]
            p = cross(dd, c[None])
            det = dot(b[None], p)
            inv = 1.0 / jnp.where(det == 0.0, 1.0, det)
            tv = oo - a[None]
            u = dot(tv, p) * inv
            q = cross(tv, b[None])
            v = dot(dd, q) * inv
            t = dot(c[None], q) * inv
            inside = ((det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                      & (t > t_min))
            front = (det > 0.0) if cull_backface else True
            tc = jnp.where(inside & front, t, jnp.inf)
            i = jnp.argmin(tc, axis=1)
            tc = jnp.min(tc, axis=1)
            better = tc < best_t
            occ = occ | jnp.any(inside & (t < seg[:, None]), axis=1)
            return (jnp.where(better, tc, best_t),
                    jnp.where(better, base + i, best_i), occ), None

        r = o.shape[0]
        init = (jnp.full((r,), jnp.inf), jnp.full((r,), -1, jnp.int32),
                jnp.zeros((r,), bool))
        bases = jnp.arange(tris.shape[0], dtype=jnp.int32) * chunk
        (best_t, best_i, occ), _ = jax.lax.scan(body, init, (tris, bases))
        return jnp.where(jnp.isfinite(best_t), best_i, -1), occ

    tri, occ = run(jnp.asarray(o), jnp.asarray(d), jnp.asarray(seg), tris)
    return np.asarray(tri), np.asarray(occ)


def _hit_sets(scene, cam_params, size, n_rays, seed):
    """(origins, directions, t_min) of n_rays primary rays and of bounce
    rays from those that hit, as numpy."""
    from dxrexperiments_tpu.accel import traverse

    stride = max(size * size // n_rays, 1)
    o, d = _primary_subset(cam_params, size, size, stride)
    rec = traverse.closest(scene["bvh"], o, d, 0.0, 1e38, cull_backface=True)
    hit = np.asarray(rec["hit"])
    pn = np.asarray(scene["pn"])[np.maximum(np.asarray(rec["tri"]), 0)]
    bo, bd = _bounce_rays(np.asarray(o)[hit], np.asarray(d)[hit],
                          np.asarray(rec["t"])[hit], pn[hit], seed)
    return [("primary", np.asarray(o), np.asarray(d), 0.0),
            ("bounce", bo, bd, 1e-4)]


def phase_bvh(device, size=512, samples=2, n_rays=65536, n_host=256,
              scene_name="instanced:32"):
    import jax.numpy as jnp

    from dxrexperiments_tpu.accel import bvh as bvh_mod
    from dxrexperiments_tpu.accel import traverse
    from dxrexperiments_tpu.models.progressive import make_progressive_step
    from dxrexperiments_tpu.ops import intersect
    from dxrexperiments_tpu.scene.scene import BVH_LEAF_SIZE
    from dxrexperiments_tpu.trace.integrator import default_options

    checks = Checks("3")
    sc, cam = _scene(scene_name, size, size)
    t0 = time.perf_counter()
    scene = sc.build()
    build_s = time.perf_counter() - t0
    n_tris = int(scene["num_tris"])
    if "bvh" not in scene:
        raise CheckFailed("3: the instanced scene has no BVH")
    batches = [_first(b) for b in progressive_cameras(cam, size, size,
                                                      samples, 1)]
    step = make_progressive_step(scene, size, size)
    zero = jnp.zeros((size, size, 3), jnp.float32)
    maxit = jnp.asarray(samples, jnp.int32)
    args = (scene["lights"], scene["env"], maxit)
    _, first = _timed(step, zero, default_options(), batches[0], *args)

    def render_all():
        accum = zero
        for cams in batches:
            accum = step(accum, default_options(), cams, *args)
        return accum

    img, total = _timed(render_all)
    print(f"  phase 3 scene: {n_tris} triangles, host build {build_s:.2f} s",
          flush=True)
    _times_line(f"3 bvh {scene_name} flattened {size}x{size} {samples} spp",
                device, first - total / samples, "sample", total / samples,
                size * size)
    if not np.isfinite(np.asarray(img)).all():
        raise CheckFailed("3: non-finite image")

    sets = _hit_sets(scene, batches[0], size, n_rays, 3)
    v0, e1, e2 = (np.asarray(scene[k]) for k in ("v0", "e1", "e2"))
    rng = np.random.default_rng(4)
    for name, o, d, t_min in sets:
        o, d = jnp.asarray(o), jnp.asarray(d)
        cull = name == "primary"
        walk = traverse.closest(scene["bvh"], o, d, t_min, 1e38,
                                cull_backface=cull)
        brute = intersect.intersect_closest(scene, o, d, t_min, 1e38,
                                            cull_backface=cull)
        print(f"  phase 3 {name}: {o.shape[0]} rays, "
              f"{float(np.asarray(brute['hit']).mean()):.3f} hit", flush=True)
        check_hits(checks, f"{name} closest vs brute", walk["tri"], walk["t"],
                   brute["tri"], brute["t"])
        seg = jnp.asarray(rng.uniform(0.5, 40.0, o.shape[0]).astype(np.float32))
        walk_any = traverse.any_hit(scene["bvh"], o, d, t_min, seg)
        check_occlusion(checks, f"{name} any vs brute", walk_any,
                        intersect.intersect_any(scene, o, d, t_min, seg))
        # The intersection math itself, against the textbook intersector.
        mt_tri, mt_occ = plain_mt(v0, e1, e2, o, d, t_min, seg, cull)
        k = np.maximum(mt_tri, 0)
        t64 = _vec_mt64(v0[k], e1[k], e2[k], np.asarray(o), np.asarray(d))
        check_hits(checks, f"{name} closest vs plain MT (t in float64)",
                   walk["tri"], walk["t"], mt_tri, np.where(mt_tri >= 0, t64, -1))
        check_occlusion(checks, f"{name} any vs plain MT", walk_any, mt_occ)

    # The host traversal over the same (deterministic) build.
    nodes = bvh_mod.build_bvh_sah(v0, e1, e2, n_tris, BVH_LEAF_SIZE)
    if nodes is None:
        nodes = bvh_mod.to_node_arrays(
            bvh_mod.build_bvh(v0, e1, e2, n_tris, BVH_LEAF_SIZE))

    def tri_test(k, o, d):
        return _scalar_mt(v0[k].astype(np.float64), e1[k].astype(np.float64),
                          e2[k].astype(np.float64), o, d)

    for name, o, d, t_min in sets:
        pick = np.linspace(0, len(o) - 1, n_host // 2).astype(np.int64)
        ho, hd = o[pick].astype(np.float64), d[pick].astype(np.float64)
        ref = [bvh_mod.traverse_nodes_numpy(nodes, tri_test, ho[i], hd[i],
                                            max(t_min, 1e-12), np.inf)
               for i in range(len(pick))]
        walk = traverse.closest(scene["bvh"], jnp.asarray(o[pick]),
                                jnp.asarray(d[pick]), t_min, 1e38)
        check_hits(checks, f"{name} closest vs host traversal",
                   walk["tri"], walk["t"],
                   np.array([r[1] for r in ref]),
                   np.array([r[0] if r[1] >= 0 else -1.0 for r in ref]))
    checks.done()


def _flat_index(scene2: dict, rec: dict, inst_tri_base: np.ndarray):
    """Two-level (object-space tri, instance slot) -> flattened tri id."""
    meta = scene2["tlas_meta"].value
    tri = np.asarray(rec["tri"])
    slot = np.maximum(np.asarray(rec["inst"]), 0)
    orig = np.asarray(scene2["tlas"]["inst_orig"])[slot]
    mesh_base = np.array([r[0] for r in meta["mesh_tri_ranges"]])
    local = tri - mesh_base[meta["slot_mesh"][slot]]
    return np.where(tri >= 0, inst_tri_base[orig] + local, -1)


def phase_two_level(device, size=512, frames=3, n_rays=65536,
                    scene_name="instanced:32"):
    import jax
    import jax.numpy as jnp

    from dxrexperiments_tpu.accel import traverse
    from dxrexperiments_tpu.models.progressive import (
        ProgressiveRaytracingPipeline,
    )

    checks = Checks("4")
    sc, cam = _scene(scene_name, size, size)
    t0 = time.perf_counter()
    scene2 = sc.build_two_level()
    build_s = time.perf_counter() - t0
    pipe = ProgressiveRaytracingPipeline(size, size, seed=0)
    pipe.set_camera(cam)
    pipe.set_scene_data(scene2)
    base_tf = np.stack([inst.transform for inst in sc.instances])

    def transforms(frame):
        c, s = np.cos(0.05 * frame), np.sin(0.05 * frame)
        rot = np.eye(4, dtype=np.float32)
        rot[0, 0], rot[0, 2], rot[2, 0], rot[2, 2] = c, s, -s, c
        return np.einsum("ij,njk->nik", rot, base_tf).astype(np.float32)

    def frame(f):
        pipe.set_instance_transforms(jnp.asarray(transforms(f)))
        pipe.update(elapsed_time=f / 60.0, elapsed_frames=f)
        return pipe.render()

    _, first = _timed(frame, 0)
    t0 = time.perf_counter()
    for f in range(1, frames):
        img = frame(f)
    jax.block_until_ready(img)
    per_frame = (time.perf_counter() - t0) / (frames - 1)
    print(f"  phase 4 scene: {sc.num_instances} instances, host build "
          f"{build_s:.2f} s", flush=True)
    _times_line(f"4 two-level {scene_name} animated {size}x{size}", device,
                first - per_frame, "frame", per_frame, size * size)
    if not np.isfinite(np.asarray(img)).all():
        raise CheckFailed("4: non-finite image")

    # Flattened single-level scene at the last frame's transforms.
    last = transforms(frames - 1)
    for inst, tf in zip(sc.instances, last):
        inst.transform = tf
    flat = sc.build()
    counts = np.array([len(inst.mesh.indices) for inst in sc.instances])
    inst_tri_base = np.concatenate([[0], np.cumsum(counts)[:-1]])
    tl = pipe.scene_data["tlas"]
    sets = _hit_sets(flat, pipe._camera_params, size, n_rays, 5)
    rng = np.random.default_rng(6)
    for name, o, d, t_min in sets:
        o, d = jnp.asarray(o), jnp.asarray(d)
        cull = name == "primary"
        rec2 = traverse.two_level_closest(tl, o, d, t_min, 1e38,
                                          cull_backface=cull)
        rec1 = traverse.closest(flat["bvh"], o, d, t_min, 1e38,
                                cull_backface=cull)
        check_hits(checks, f"{name} two-level vs flattened",
                   _flat_index(pipe.scene_data, rec2, inst_tri_base),
                   rec2["t"], rec1["tri"], rec1["t"], t_floor=1.0)
        seg = jnp.asarray(rng.uniform(0.5, 40.0, o.shape[0]).astype(np.float32))
        check_occlusion(checks, f"{name} any two-level vs flattened",
                        traverse.two_level_any(tl, o, d, t_min, seg),
                        traverse.any_hit(flat["bvh"], o, d, t_min, seg))
    checks.done()


def phase_cli(device, size=512, spp=16):
    from dxrexperiments_tpu.app.headless import main as headless_main
    from dxrexperiments_tpu.utils.image import read_png

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cornell.png")
        t0 = time.perf_counter()
        rc = headless_main(["--scene", "cornell-glossy", "--size",
                            f"{size}x{size}", "--spp", str(spp), "--tonemap",
                            "-o", path])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise CheckFailed(f"5: headless exited {rc}")
        img = read_png(path)
    mean = float(img.mean()) / 255.0
    print(f"phase 5 headless cli cornell-glossy {size}x{size} {spp} spp: "
          f"wall {wall:.2f} s incl. compile, png {img.shape[1]}x"
          f"{img.shape[0]} mean {mean:.4f}, peak {_peak_mib(device):.0f} MiB",
          flush=True)
    checks = Checks("5")
    checks.at_least("png width", img.shape[1], size)
    checks.at_most("png width", img.shape[1], size)
    checks.at_least("png height", img.shape[0], size)
    checks.at_most("png height", img.shape[0], size)
    checks.at_least("png mean", mean, 0.02)
    checks.at_most("png mean", mean, 0.98)
    checks.done()


# --------------------------------------------------------------------------- #
# Four cards
# --------------------------------------------------------------------------- #
def _distinct_devices(arr) -> int:
    return len({d.id for d in arr.sharding.device_set})


def four_card_progressive(devices, size=512, spp=64, per_step=16):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dxrexperiments_tpu.parallel import (
        make_render_mesh, make_sharded_progressive_step, replicate_scene,
    )
    from dxrexperiments_tpu.trace.integrator import default_options

    checks = Checks("4-card progressive")
    mesh = make_render_mesh(n_tile=2, n_spp=2, devices=devices[:4])
    sc, cam = _scene("cornell-glossy", size, size)
    scene = sc.build()
    batches = progressive_cameras(cam, size, size, spp, per_step)
    step = make_sharded_progressive_step(scene, size, size, mesh,
                                         samples_per_step=per_step)
    def zero():  # the sharded step donates its accumulator
        return jax.device_put(jnp.zeros((size, size, 3), jnp.float32),
                              NamedSharding(mesh, P("tile", None, None)))

    options, lights, env, maxit = replicate_scene(
        (default_options(), scene["lights"], scene["env"],
         jnp.asarray(spp, jnp.int32)), mesh)
    cam_sharding = NamedSharding(mesh, P("spp"))
    batches = [jax.device_put(b, cam_sharding) for b in batches]
    _, first = _timed(step, zero(), options, batches[0], lights, env, maxit)

    def render_all():
        accum = zero()
        for cams in batches:
            accum = step(accum, options, cams, lights, env, maxit)
        return accum

    img, total = _timed(render_all)
    _times_line(f"4-card progressive 2x2 cornell-glossy {size}x{size} "
                f"{spp} spp, {per_step} samples/dispatch", devices[0],
                first - total / len(batches), "sample", total / spp,
                size * size)
    checks.at_least("shards on distinct devices", _distinct_devices(img), 4)
    check_images(checks, "2x2 mesh vs one card", img,
                 _accumulate(devices[0], sc, size, size,
                             [jax.device_get(b) for b in batches], spp))
    checks.done()


def four_card_realtime(devices, width=1920, height=1080, frames=8):
    import jax

    from dxrexperiments_tpu.core.camera import camera_params
    from dxrexperiments_tpu.models.denoise import (
        default_denoise_params, denoise_composite,
    )
    from dxrexperiments_tpu.parallel import (
        make_render_mesh, make_sharded_realtime_step, replicate_scene,
    )
    from dxrexperiments_tpu.trace.integrator import (
        default_options, make_render_step,
    )

    checks = Checks("4-card realtime")
    mesh = make_render_mesh(n_tile=4, n_spp=1, devices=devices[:4])
    sc, cam = _scene("cornell-glossy", width, height)
    scene = sc.build()
    cams = [camera_params(cam, jitter=(0.3 / width, -0.2 / height),
                          frame_count=5 + f) for f in range(frames)]
    params = default_denoise_params()
    step = make_sharded_realtime_step(scene, width, height, mesh,
                                      denoise=True)
    options, lights, env, dparams = replicate_scene(
        (default_options(), scene["lights"], scene["env"], params), mesh)
    resident = replicate_scene(cams, mesh)
    out, first = _timed(step, options, resident[0], lights, env, dparams)

    def render_all():
        return [step(options, c, lights, env, dparams) for c in resident[1:]]

    _, total = _timed(render_all)
    per_frame = total / (frames - 1)
    _times_line(f"4-card realtime+denoise 4x1 {width}x{height}, "
                f"{frames - 1} frames one per dispatch", devices[0],
                first - per_frame, "frame", per_frame, width * height)
    args = (default_options(), cams[0], scene["lights"], scene["env"], params)
    checks.at_least("shards on distinct devices",
                    _distinct_devices(out["display"]), 4)
    with jax.default_device(devices[0]):
        one = make_render_step(scene, width, height, mode="realtime",
                               jitter_scale=10.0)(*args[:4])
        display = denoise_composite(one["direct"], one["indirect_specular"],
                                    params)
    for key in ("direct", "indirect_specular"):
        check_images(checks, f"4x1 {key} vs one card", out[key], one[key])
    check_images(checks, "4x1 composite vs one card", out["display"], display)
    checks.done()


# --------------------------------------------------------------------------- #
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    from dxrexperiments_tpu.utils.runtime import (
        card_description, enable_compile_cache,
    )

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default device is "
              f"{devices[0].platform}", file=sys.stderr)
        return 1
    if args.four_cards and len(devices) < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, JAX sees "
              f"{len(devices)}", file=sys.stderr)
        return 1
    cache = enable_compile_cache()
    card = card_description()
    print(f"card: {card} | device_kind {devices[0].device_kind} | "
          f"jax {jax.__version__} | compile cache {cache}", flush=True)

    device, cpu = devices[0], jax.devices("cpu")[0]
    if args.four_cards:
        four_card_progressive(devices)
        four_card_realtime(devices)
    else:
        phase_progressive(device, cpu)
        phase_realtime(device, cpu)
        phase_bvh(device)
        phase_two_level(device)
        phase_cli(device)

    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
