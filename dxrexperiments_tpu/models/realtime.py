"""Realtime 1-spp pipeline producing denoiser AOVs.

JAX replacement for ``RealtimeRaytracingPipeline``
(/root/reference/src/RealtimeRaytracingPipeline.cpp +
assets/shaders/RealtimeRaytracing.hlsl): same program topology as the
progressive pipeline but two outputs — direct lighting and indirect
specular — no accumulation (accumCount pinned 0,
RealtimeRaytracingPipeline.cpp:181), 10x jitter scale, no indirect diffuse.
Feeds models/denoise.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.lights import default_lights
from ..trace.integrator import (
    default_options, make_render_step, render_sample, scene_geometry,
)
from .base import RaytracingPipeline, wall_seed


@functools.partial(jax.jit, static_argnames=("width", "height"))
def realtime_step(scene: dict, options: dict, camera: dict, width: int, height: int):
    out = render_sample(
        scene, options, camera, width, height, mode="realtime", jitter_scale=10.0
    )
    return out["direct"], out["indirect_specular"]


class RealtimeRaytracingPipeline(RaytracingPipeline):
    name = "Realtime Raytracing"

    def __init__(self, width: int = 1920, height: int = 1080, seed: int | None = None):
        super().__init__()
        self.options = default_options()
        self.rng = np.random.default_rng(wall_seed() if seed is None else seed)
        self.animation_paused = True
        self.create_output_resource(width, height)
        self._camera_params = None

    def create_output_resource(self, width: int, height: int) -> None:
        super().create_output_resource(width, height)
        self.direct = jnp.zeros((height, width, 3), jnp.float32)
        self.indirect_specular = jnp.zeros((height, width, 3), jnp.float32)

    @property
    def num_outputs(self) -> int:
        return 2  # (RealtimeRaytracingPipeline::getNumOutputs()==2)

    def update(self, elapsed_time: float, elapsed_frames: int) -> None:
        if self.animation_paused:
            elapsed_time = 142.0
        # accumCount pinned to 0 (RealtimeRaytracingPipeline.cpp:181).
        self._camera_params = self._frame_camera_params(elapsed_frames, 0, self.rng)
        if self.scene_data is not None and getattr(self, "owns_lights", False):
            self.scene_data = dict(self.scene_data, lights=default_lights(elapsed_time))

    def _step_fn(self):
        # Geometry is an argument of the compiled step (see
        # ProgressiveRaytracingPipeline._step_fn); only a new size or env
        # kind rebuilds it.
        cfg = (self.width, self.height, int(self.scene_data["env"]["kind"]))
        if getattr(self, "_step_cfg", None) != cfg:
            self._step = make_render_step(
                self.scene_data,
                self.width,
                self.height,
                mode="realtime",
                jitter_scale=10.0,
            )
            self._step_cfg = cfg
        return self._step

    def render(self):
        out = self._step_fn()(
            self.options,
            self._camera_params,
            self.scene_data["lights"],
            self.scene_data["env"],
            geo_arg=scene_geometry(self.scene_data),
        )
        self.direct, self.indirect_specular = out["direct"], out["indirect_specular"]
        return self.direct, self.indirect_specular

    # ---- frames-in-flight batch (one dispatch for K frames) --------------
    # The analogue of the reference's 3-deep frame ring
    # (/root/reference/include/DXRExperimentsApp.h:27,
    # src/utils/DeviceResources.cpp:580-598): batching K frames' cameras
    # into one dispatch trades K frames of input latency (the same latency
    # class the reference's in-flight ring accepts) for one host dispatch
    # per K frames. Equal to K sequential render() calls when lights/env
    # are static across the batch (see render_frames).

    def _frames_step_fn(self, k: int):
        cfg = (self.width, self.height, k, int(self.scene_data["env"]["kind"]))
        if getattr(self, "_frames_cfg", None) != cfg:
            self._frames_step = make_render_step(
                self.scene_data,
                self.width,
                self.height,
                mode="realtime",
                jitter_scale=10.0,
                frames_per_step=k,
            )
            self._frames_cfg = cfg
        return self._frames_step

    def frame_cameras(self, elapsed_frames: int, k: int) -> dict:
        """CameraParams for frames [elapsed_frames, elapsed_frames+k),
        stacked on a leading [k] axis (per-frame jitter drawn in order, as
        k sequential update() calls would)."""
        cams = [
            self._frame_camera_params(elapsed_frames + f, 0, self.rng)
            for f in range(k)
        ]
        return jax.tree.map(lambda *xs: jnp.stack(xs), *cams)

    def render_frames(self, elapsed_frames: int, k: int):
        """Render frames [elapsed_frames, elapsed_frames+k) in ONE dispatch.
        Returns (direct [k,H,W,3], indirect_specular [k,H,W,3]); the last
        frame's AOVs become the pipeline's current outputs.

        Lights and env are FROZEN at dispatch time for all K frames: a
        sequential update()+render() loop with owns_lights and animation
        unpaused re-derives default_lights(elapsed_time) per frame, which
        this batch does not. With animation paused (the reference default,
        ProgressiveRaytracingPipeline.cpp:30) or a scene-owned static rig,
        the batch is bit-identical to K sequential render() calls
        (tested); unpaused owns_lights callers should step lights
        themselves or stay on the per-frame path."""
        cameras = self.frame_cameras(elapsed_frames, k)
        out = self._frames_step_fn(k)(
            self.options,
            cameras,
            self.scene_data["lights"],
            self.scene_data["env"],
            geo_arg=scene_geometry(self.scene_data),
        )
        self.direct = out["direct"][-1]
        self.indirect_specular = out["indirect_specular"][-1]
        return out["direct"], out["indirect_specular"]

    def get_output(self, index: int = 0) -> jnp.ndarray:
        return self.direct if index == 0 else self.indirect_specular


def make_realtime_denoise_frames_step(
    scene: dict,
    width: int,
    height: int,
    frames_per_step: int,
):
    """One jitted step = K realtime frames + their denoise/composite, in a
    SINGLE host dispatch (lax.map'd raytrace and filter chains). This is the
    config-4 production shape: the reference hides per-frame CPU/GPU sync
    behind its 3-deep frame ring
    (/root/reference/src/utils/DeviceResources.cpp:580-598); here the same
    K-frame latency budget buys one dispatch per K frames.

    Returns ``step(options, cameras_K, lights, env, denoise_params,
    geo_arg=None) -> (aov_dict_K, display_frames [K, H, W, 3])``.
    """
    from .denoise import denoise_composite_frames

    rt_step = make_render_step(
        scene, width, height, mode="realtime", jitter_scale=10.0,
        frames_per_step=frames_per_step,
    )
    geo = scene_geometry(scene)

    @jax.jit
    def inner(options, cameras, lights, env, denoise_params, geo_arg):
        if frames_per_step > 1:
            out = rt_step(options, cameras, lights, env, geo_arg)
        else:  # K=1 still takes stacked [1] cameras
            cam = jax.tree.map(lambda x: x[0], cameras)
            out = jax.tree.map(lambda x: x[None],
                               rt_step(options, cam, lights, env, geo_arg))
        img = denoise_composite_frames(
            out["direct"], out["indirect_specular"], denoise_params
        )
        return out, img

    def step(options, cameras, lights, env, denoise_params, geo_arg=None):
        return inner(options, cameras, lights, env, denoise_params,
                     geo if geo_arg is None else geo_arg)

    return step
