"""Frames-in-flight batching: K realtime frames in ONE dispatch.

The analogue of the reference's 3-deep frame ring
(/root/reference/include/DXRExperimentsApp.h:27,
src/utils/DeviceResources.cpp:580-598): a lax.map over per-frame cameras
wraps the single-frame wavefront renderer. Batched output must match K
sequential single-frame renders (fp-fusion tolerance), on the brute-force
and on the BVH route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dxrexperiments_tpu.app.headless import build_scene
from dxrexperiments_tpu.core.camera import camera_params
from dxrexperiments_tpu.models.denoise import (
    default_denoise_params,
    denoise_composite,
    denoise_composite_frames,
)
from dxrexperiments_tpu.models.realtime import (
    RealtimeRaytracingPipeline,
    make_realtime_denoise_frames_step,
)
from dxrexperiments_tpu.trace.integrator import (
    default_options,
    make_render_step,
    render_sample,
)

W = H = 32
AOV_KEYS = ("color", "direct", "indirect_specular", "albedo", "roughness")


def glossy_scene(accel="auto"):
    sc, cam = build_scene("cornell-glossy")
    cam.set_aspect(W, H)
    return sc.build(accel=accel), cam


def cams_k(cam, k):
    cams = [
        camera_params(cam, jitter=(0.001 * i, -0.002 * i), frame_count=i)
        for i in range(k)
    ]
    return cams, jax.tree.map(lambda *xs: jnp.stack(xs), *cams)


@pytest.mark.parametrize("accel", ["none", "bvh"])
def test_render_step_frames_match_single(accel):
    """make_render_step(frames_per_step=K) returns stacked AOVs matching
    the single-frame step, on the brute-force and the BVH route."""
    scene, cam = glossy_scene(accel)
    opts = default_options()
    cams, stack = cams_k(cam, 3)
    step1 = make_render_step(scene, W, H, mode="realtime", jitter_scale=10.0)
    stepk = make_render_step(
        scene, W, H, mode="realtime", jitter_scale=10.0, frames_per_step=3,
    )
    out = stepk(opts, stack, scene["lights"], scene["env"])
    for i, c in enumerate(cams):
        ref = step1(opts, c, scene["lights"], scene["env"])
        for k in AOV_KEYS:
            np.testing.assert_allclose(
                np.asarray(ref[k]), np.asarray(out[k])[i],
                atol=1e-6, err_msg=f"{k}/frame{i}",
            )


def test_render_step_frames_wavefront():
    """The generic (lax.map) path: jnp wavefront batched == per-frame."""
    scene, cam = glossy_scene()
    opts = default_options()
    cams, stack = cams_k(cam, 2)
    stepk = make_render_step(
        scene, W, H, mode="realtime", jitter_scale=10.0, frames_per_step=2,
    )
    out = stepk(opts, stack, scene["lights"], scene["env"])
    for i, c in enumerate(cams):
        ref = render_sample(
            scene, opts, c, W, H, mode="realtime", jitter_scale=10.0,
        )
        np.testing.assert_allclose(
            np.asarray(ref["direct"]), np.asarray(out["direct"])[i],
            atol=1e-6,
        )


def test_render_step_frames_bvh_vs_brute():
    """The frame batch on the BVH route reproduces per-frame render_sample
    on the brute-force route."""
    scene, cam = glossy_scene("bvh")
    brute, _ = glossy_scene("none")
    opts = default_options()
    # frames 1 and 2: frame 0's unjittered rays run exactly along the box's
    # corner seams, where either route may report either wall
    cams, stack = cams_k(cam, 3)
    cams, stack = cams[1:], jax.tree.map(lambda x: x[1:], stack)
    stepk = make_render_step(
        scene, W, H, mode="realtime", jitter_scale=10.0, frames_per_step=2,
    )
    out = stepk(opts, stack, scene["lights"], scene["env"])
    for i, c in enumerate(cams):
        ref = render_sample(
            brute, opts, c, W, H, mode="realtime", jitter_scale=10.0,
        )
        for k in AOV_KEYS:
            diff = np.abs(np.asarray(ref[k]) - np.asarray(out[k])[i])
            bad = diff.reshape(H * W, -1).max(axis=-1) > 1e-3
            assert bad.mean() <= 0.005, f"{k}/frame{i}"
            assert float(np.median(diff)) < 1e-5, f"{k}/frame{i}"


def test_frames_per_step_rejects_progressive():
    scene, _ = glossy_scene()
    with pytest.raises(ValueError):
        make_render_step(scene, W, H, mode="progressive", frames_per_step=2)


def test_pipeline_render_frames_matches_sequential():
    """RealtimeRaytracingPipeline.render_frames == K update()+render()
    (same seed => same per-frame jitter draw order)."""
    sc, cam = build_scene("cornell-glossy")
    cam.set_aspect(W, H)

    def mk():
        p = RealtimeRaytracingPipeline(W, H, seed=7)
        p.set_camera(cam)
        p.set_scene(sc)
        return p

    pa, pb = mk(), mk()
    d_batch, s_batch = pa.render_frames(0, 3)
    for f in range(3):
        pb.update(0.0, f)
        d, s = pb.render()
        np.testing.assert_allclose(
            np.asarray(d), np.asarray(d_batch)[f], atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(s), np.asarray(s_batch)[f], atol=1e-6
        )
    # last frame's AOVs become the pipeline's current outputs
    np.testing.assert_array_equal(
        np.asarray(pa.direct), np.asarray(d_batch)[-1]
    )


def test_denoise_composite_frames():
    rng = np.random.default_rng(3)
    d = jnp.asarray(rng.random((2, 16, 24, 3), np.float32))
    s = jnp.asarray(rng.random((2, 16, 24, 3), np.float32))
    params = default_denoise_params()
    out = denoise_composite_frames(d, s, params)
    for i in range(2):
        ref = denoise_composite(d[i], s[i], params)
        np.testing.assert_allclose(
            np.asarray(ref), np.asarray(out)[i], atol=1e-6
        )


def test_dispatch_frames_temporal_matches_sequential():
    """Batched temporal dispatch (lax.scan-carried history) must advance
    the history exactly as K sequential dispatch() calls, including the
    first-frame seeding and continuation across batches."""
    from dxrexperiments_tpu.models.denoise import DenoiseCompositor

    rng = np.random.default_rng(11)
    d = jnp.asarray(rng.random((5, 12, 20, 3), np.float32))
    s = jnp.asarray(rng.random((5, 12, 20, 3), np.float32))
    seq = DenoiseCompositor(temporal_alpha=0.3)
    bat = DenoiseCompositor(temporal_alpha=0.3)
    want = [np.asarray(seq.dispatch(d[i], s[i])) for i in range(5)]
    # two batches (3 + 2) to exercise history continuation across dispatches
    got = list(np.asarray(bat.dispatch_frames(d[:3], s[:3])))
    got += list(np.asarray(bat.dispatch_frames(d[3:], s[3:])))
    for i in range(5):
        np.testing.assert_allclose(want[i], got[i], atol=1e-6, err_msg=str(i))
    np.testing.assert_allclose(
        np.asarray(seq._history), np.asarray(bat._history), atol=1e-6
    )
    # non-temporal dispatch_frames == plain batched composite
    plain = DenoiseCompositor()
    out = plain.dispatch_frames(d[:2], s[:2])
    ref = denoise_composite(d[0], s[0], plain.params)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(out)[0], atol=1e-6)


def test_realtime_denoise_frames_step():
    """The combined one-dispatch step: K raytraced frames + their denoised
    composites, matching the two-call chain."""
    scene, cam = glossy_scene()
    opts = default_options()
    _, stack = cams_k(cam, 2)
    den = default_denoise_params()
    comb = make_realtime_denoise_frames_step(scene, W, H, 2)
    aovs, img = comb(opts, stack, scene["lights"], scene["env"], den)
    assert np.asarray(img).shape == (2, H, W, 3)
    for i in range(2):
        ref = denoise_composite(
            aovs["direct"][i], aovs["indirect_specular"][i], den
        )
        np.testing.assert_allclose(
            np.asarray(ref), np.asarray(img)[i], atol=1e-6
        )
